"""The port's dense LM against the JAX package's, on the CPU.

Parameters come from the reference's ``LM(cfg).init`` and are converted with
``repro_torch.convert.params_from_reference`` — never re-initialised — and
tokens, prefix embeddings and masks are made with numpy from a seed, so both
packages compute the same function of the same numbers.  The configs are the
reference's ``reduced()`` ones of six dense architectures; between them they
cover grouped-query attention, ``qk_norm``, sliding windows, GELU, a
non-gated FFN (``mul=None``) and stub-frontend ``prefix_embeds``.

Tolerance: 1e-4 absolute on logits (observed differences are a few 1e-6;
the two packages sum matrix products and softmaxes in other orders), which
a wrong rotary angle, a dropped gate or a mixed-up candidate exceeds by
orders of magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-4)
ARCHS = ["stablelm_1p6b", "qwen3_32b", "gemma3_27b", "mistral_nemo_12b",
         "musicgen_large", "paligemma_3b"]
B, S = 2, 12

_CACHE = {}


def _window(cfg, size):
    """The same config with every block's attention window set to
    ``size`` (the reduced configs' 1024 would not bite at these lengths)."""
    pat = tuple(dataclasses.replace(b, window=size) for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pat)


def _build(arch, n_layers=None, window=None):
    """(ref, reference model, params, port model, converted params): the
    same reduced config in both packages, cached per process."""
    key = (arch, n_layers, window)
    if key in _CACHE:
        return _CACHE[key]
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    rcfg = ref.configs.get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    if window is not None:
        rcfg, tcfg = _window(rcfg, window), _window(tcfg, window)
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    _CACHE[key] = ref, rmodel, rparams, tmodel, tparams
    return _CACHE[key]


def _tokens(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)


def _dev(tree):
    from repro_torch.core import masks as M
    return M.as_device(tree, "cpu")


def _ref_logits(ref, rmodel, rparams, tree, toks, pe=None):
    j = ref.jnp.asarray
    out, _ = rmodel.forward(rparams, ref.masks.as_device(tree), j(toks),
                            prefix_embeds=None if pe is None else j(pe))
    return np.asarray(out)


@pytest.mark.parametrize("arch", ARCHS + ["gemma3_27b@window3", "rwkv6_3b"])
def test_logits_match_reference(arch):
    name, _, w = arch.partition("@window")
    ref, rmodel, rparams, tmodel, tparams = _build(
        name, window=int(w) if w else None)
    cfg = tmodel.cfg
    toks = _tokens(cfg, 1)
    pe = None
    if cfg.prefix_len:
        pe = np.random.default_rng(2).normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    for seed in (3, 4):
        tree = random_masks(tmodel.mask_sites(), seed)
        want = _ref_logits(ref, rmodel, rparams, tree, toks, pe)
        got = tmodel.forward(tparams, _dev(tree), torch.from_numpy(toks),
                             prefix_embeds=None if pe is None
                             else torch.from_numpy(pe))
        assert got.shape == want.shape == (B, S + cfg.prefix_len, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # ties=False only skips the (inert, for binary masks) tie override
        np.testing.assert_array_equal(
            tmodel.forward(tparams, _dev(tree), torch.from_numpy(toks),
                           prefix_embeds=None if pe is None
                           else torch.from_numpy(pe), ties=False).numpy(),
            got.numpy())


@pytest.mark.parametrize("arch", ["stablelm_1p6b", "musicgen_large"])
def test_fused_forward_matches_reference_fused_route(arch):
    """fused=True (gate [· up] · w_down as one kernel entry) against the
    reference traced under ``fused_suffix_route(interpret=True)``, stacked
    against ``jax.vmap`` of it, and both against the port's unfused forward.
    musicgen's FFN is not gated (``mul=None``)."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    toks = _tokens(tmodel.cfg, 5)
    trees = [random_masks(tmodel.mask_sites(), 6 + i) for i in range(3)]
    x = torch.from_numpy(toks)
    j = ref.jnp.asarray
    stacked = M.stack_trees(trees)
    with ref.linearize.fused_suffix_route(interpret=True):
        want = np.asarray(rmodel.forward(
            rparams, ref.masks.as_device(trees[0]), j(toks))[0])
        want_st = np.asarray(ref.jax.vmap(
            lambda m: rmodel.forward(rparams, m, j(toks))[0])(
                ref.masks.as_device(stacked)))
    got = tmodel.forward(tparams, _dev(trees[0]), x, fused=True, ties=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tmodel.forward(tparams, _dev(trees[0]), x).numpy(), got.numpy(),
        **TOL)
    pre = tmodel.forward_pre(tparams, x)
    got_st = tmodel.forward(tparams, _dev(stacked), None, pre=pre,
                            fused=True, ties=False)
    assert got_st.shape == (3, B, S, tmodel.cfg.vocab)
    np.testing.assert_allclose(got_st.numpy(), want_st, **TOL)
    plain_st = tmodel.forward(tparams, _dev(stacked), x)
    np.testing.assert_allclose(plain_st.numpy(), want_st, **TOL)
    # candidate i of the stack is the un-stacked forward of tree i
    for i, tree in enumerate(trees):
        one = tmodel.forward(tparams, _dev(tree), x)
        np.testing.assert_allclose(plain_st[i].numpy(), one.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm_1p6b", "gemma3_27b",
                                  "stablelm_1p6b@6", "rwkv6_3b"])
def test_site_bookkeeping_equals_reference(arch):
    name, _, nl = arch.partition("@")
    ref, rmodel, rparams, tmodel, tparams = _build(
        name, n_layers=int(nl) if nl else None)
    rs, ts = rmodel.mask_sites(), tmodel.mask_sites()
    assert list(rs) == list(ts)
    for k in rs:
        assert (rs[k].shape, rs[k].kind, rs[k].replacement) == \
            (ts[k].shape, ts[k].kind, ts[k].replacement)
    assert rmodel.site_order() == tmodel.site_order()
    assert rmodel.site_segments() == tmodel.site_segments()
    assert rmodel.site_repeats() == tmodel.site_repeats()
    for s in tmodel.site_segments():
        assert rmodel.suffix_sites(s) == tmodel.suffix_sites(s), s
    assert rmodel.site_prefix_fractions() == tmodel.site_prefix_fractions()
    assert rmodel.site_prefix_fractions(seq_len=512) == \
        tmodel.site_prefix_fractions(seq_len=512)
    # the port's own init makes the reference's tree (keys, shapes, dtypes)
    own = tmodel.init(torch.Generator().manual_seed(0), "cpu")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if isinstance(t, list):
            return [layout(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert layout(own) == layout(tparams)


@pytest.mark.parametrize("arch", [
    "zamba2_2p7b", "stablelm_1p6b", "mistral_nemo_12b", "qwen3_32b",
    "gemma3_27b", "mixtral_8x22b", "deepseek_moe_16b", "rwkv6_3b",
    "paligemma_3b", "musicgen_large"])
def test_configs_equal_reference(arch):
    """The copied config registry: every field, derived property and
    reduced config equal to the reference's, and the shape cells and their
    applicability too."""
    from repro_torch import configs as T
    R = reference().configs
    assert T.ARCH_IDS == R.ARCH_IDS and arch in T.ARCH_IDS
    for rc, tc in ((R.get_config(arch), T.get_config(arch)),
                   (R.get_config(arch).reduced(),
                    T.get_config(arch).reduced())):
        assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
        assert (rc.n_repeats, rc.d_inner) == (tc.n_repeats, tc.d_inner)
        assert [dataclasses.asdict(b) for b in rc.tail] == \
            [dataclasses.asdict(b) for b in tc.tail]
        for shape in R.SHAPES:
            assert dataclasses.asdict(R.SHAPES[shape]) == \
                dataclasses.asdict(T.SHAPES[shape])
            assert R.cell_applicable(rc, shape) == \
                T.cell_applicable(tc, shape)


def test_full_size_stablelm_sites():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    m = LM(get_config("stablelm_1p6b"))
    assert m.cfg.n_repeats == 24 and m.cfg.d_ff == 5632
    assert m.relu_count() == 24 * 5632 == 135168
    assert m.site_order()[0] == "s0.ffn@0" and len(m.site_order()) == 24


@pytest.mark.parametrize("arch", ["stablelm_1p6b@6", "gemma3_27b",
                                  "rwkv6_3b"])
def test_prefix_suffix_at_every_site(arch):
    """prefix ∘ suffix == forward (exactly: the same fold), prefix_ext(a →
    b) == prefix(b), prefixes against the reference's, and the stacked
    suffix — unfused and fused — over the one shared prefix against full
    stacked forwards of the spliced trees, at every site including each
    per-repeat ``s0.ffn@r``."""
    from repro_torch.core import masks as M
    name, _, nl = arch.partition("@")
    ref, rmodel, rparams, tmodel, tparams = _build(
        name, n_layers=int(nl) if nl else None)
    toks = _tokens(tmodel.cfg, 7)
    x = torch.from_numpy(toks)
    trees = [random_masks(tmodel.mask_sites(), 8 + i) for i in range(3)]
    md, rmd = _dev(trees[0]), ref.masks.as_device(trees[0])
    full = tmodel.forward(tparams, md, x)
    stacked = _dev(M.stack_trees(trees[1:]))
    prev_site, prev_cached = None, None
    for site in tmodel.site_order():
        cached = tmodel.forward_prefix(tparams, md, x, site)
        want = rmodel.forward_prefix(rparams, rmd, ref.jnp.asarray(toks),
                                     site)
        np.testing.assert_allclose(cached.numpy(), np.asarray(want), **TOL)
        out = tmodel.forward_suffix(tparams, md, cached, site)
        np.testing.assert_array_equal(out.numpy(), full.numpy())
        if prev_site is not None:
            ext = tmodel.forward_prefix(tparams, md, x, site,
                                        from_site=prev_site,
                                        cached=prev_cached)
            np.testing.assert_array_equal(ext.numpy(), cached.numpy())
        prev_site, prev_cached = site, cached
        # candidates agree with the base above the cut: splice the base's
        # rows before the cut into the stacked candidates
        seg = tmodel.site_segments()
        cut = seg[site]
        spliced = {}
        for k, v in md.items():
            st = stacked[k]
            if k in tmodel.site_repeats():
                r0 = cut - seg[k]
                if r0 > 0:
                    st = st.clone()
                    st[:, :r0] = v[:r0]
            elif seg[k] < cut:
                st = v.unsqueeze(0).expand((2,) + tuple(v.shape))
            spliced[k] = st
        want_st = tmodel.forward(tparams, spliced, x)
        sub = {k: spliced[k] for k in tmodel.suffix_sites(site)}
        for fused in (False, True):
            got_st = tmodel.forward_suffix(tparams, sub, cached, site,
                                           fused=fused, ties=not fused)
            np.testing.assert_allclose(got_st.numpy(), want_st.numpy(),
                                       rtol=0, atol=1e-5)


def test_eval_closures_match_reference_accuracy():
    """make_eval_acc / make_param_eval_fn / make_joint_eval_fn /
    make_suffix_eval_fns give the reference's accuracies, as equal float32
    numbers, on greedy labels whose top-2 margins exceed the tolerance."""
    from repro_torch import convert
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build("stablelm_1p6b", 6)
    batch, trees = _greedy_batch(tmodel, tparams, seed=9, n_trees=2)
    racc = rmodel.make_eval_acc(rparams, batch)
    tacc = tmodel.make_eval_acc(tparams, batch, "cpu")
    fn = tmodel.make_param_eval_fn(batch, "cpu")
    joint = tmodel.make_joint_eval_fn()
    split = tmodel.make_suffix_eval_fns()
    ctx = {"params": tparams, "batch": convert.to_device(batch, "cpu")}
    for tree in trees:
        want = racc(tree)
        assert 0.0 < want < 100.0
        assert tacc(tree) == want
        assert float(fn(_dev(tree), tparams)) == want
        assert float(joint(_dev(tree), ctx)) == want
        site = "s0.ffn@3"
        cached = split.prefix(site, _dev(tree), ctx)
        assert float(split.suffix(site, _dev(tree), cached, ctx)) == want
        ctx_pre = {**ctx, "pre": split.pre(ctx)}
        assert float(split.full(_dev(tree), ctx_pre)) == want
    accs = fn(_dev(M.stack_trees(trees)), tparams)
    assert accs.shape == (2,)
    assert [float(a) for a in accs] == [racc(t) for t in trees]


def _greedy_batch(tmodel, tparams, seed, n_trees=0, batch=4, seq=16,
                  prompt=4):
    """Eval tokens whose labels after the prompt are the full-mask model's
    own greedy continuation (random weights score ~0 on random labels), and
    ``n_trees`` random mask trees; asserts that every tree's top-2 logit
    margin exceeds 1e-4, ten times the tolerance the forwards are held
    to."""
    from repro_torch.core import linearize
    full = _dev(linearize.init_masks(tmodel.mask_sites()))
    toks = torch.from_numpy(_tokens(tmodel.cfg, seed, batch, prompt)).long()
    while toks.shape[1] < seq + 1:
        nxt = tmodel.forward(tparams, full, toks)[:, -1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    batch = {"tokens": toks.to(torch.int32).numpy()}
    trees = [random_masks(tmodel.mask_sites(), seed + 1 + i, density=0.9)
             for i in range(n_trees)]
    _assert_margins(tmodel, tparams, batch, [linearize.init_masks(
        tmodel.mask_sites())] + trees)
    return batch, trees


def _assert_margins(tmodel, tparams, batch, trees):
    x = torch.from_numpy(batch["tokens"][:, :-1])
    for tree in trees:
        logits = tmodel.forward(tparams, _dev(tree), x)
        top2 = logits.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        assert margin > 1e-4, f"top-2 logit margin {margin} too small"


def _logs(history):
    return [{k: v for k, v in dataclasses.asdict(h).items()
             if k != "wall_s"} for h in history]


def test_run_bcd_selects_the_references_blocks():
    """Reduced StableLM (6 layers, 576 nonlinearities), greedy labels:
    the port's four engines select the reference's blocks with the same
    step logs as the reference's sequential and batched engines."""
    from repro_torch.core import bcd as B, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    ref, rmodel, rparams, tmodel, tparams = _build("stablelm_1p6b", 6)
    batch, _ = _greedy_batch(tmodel, tparams, seed=11)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    total = M.count(masks0)
    kw = dict(b_target=total - 3 * 24, drc=24, rt=8, adt=-100.0,
              finetune_every_step=False, seed=3, chunk_size=3,
              moves=("remove",))
    racc = rmodel.make_eval_acc(rparams, batch)
    wants = {}
    for backend in ("sequential", "batched"):
        ev = ref.engine.make_evaluator(
            backend, eval_acc=racc,
            eval_fn=rmodel.make_eval_fn(rparams, batch), pad_to=3)
        wants[backend] = ref.bcd.run_bcd(masks0, ref.bcd.BCDConfig(**kw),
                                         racc, evaluator=ev,
                                         keep_snapshots=True)
    want = wants["batched"]
    assert _logs(wants["sequential"].history) == _logs(want.history)
    _assert_margins(tmodel, tparams, batch, want.mask_snapshots)
    # the trials did not all tie: the parity below is not vacuous
    assert len({h.best_drop for h in want.history}) > 1 or \
        any(h.best_drop != 0.0 for h in want.history)
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        ev, eval_acc, _ = make_bcd_evaluator(
            backend, tmodel, batch, {"params": tparams}, chunk_size=3, rt=8,
            prefetch=2, device="cpu")
        got = B.run_bcd(masks0, B.BCDConfig(**kw), eval_acc, evaluator=ev)
        assert M.fingerprint(got.masks) == \
            ref.masks.fingerprint(want.masks), backend
        assert _logs(got.history) == _logs(want.history), backend


@pytest.mark.parametrize("site", ["s0.ffn@2", "s0.ffn@4"])
def test_sited_suffix_matches_batched_at_midscan_sites(site):
    """Site-local candidates at one stack repeat: the port's batched engine
    equals the reference's, and the suffix engine — unfused and fused, cold
    and warm trie — equals both, computing the prefix once."""
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    ref, rmodel, rparams, tmodel, tparams = _build("stablelm_1p6b", 6)
    batch, _ = _greedy_batch(tmodel, tparams, seed=13)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    idx = M.sample_removal_indices_within(
        np.random.default_rng(0), masks0, 12, 6, [site],
        repeat_sites=tmodel.site_repeats())
    r = int(site.rsplit("@", 1)[1])
    assert np.all(idx // 96 == r)          # (R, 96) site, repeat-major rows
    stacked = M.materialize_candidates(masks0, idx)
    want = ref.engine.make_evaluator(
        "batched", eval_fn=rmodel.make_eval_fn(rparams, batch), pad_to=4
    ).evaluate(stacked)
    assert len(set(want)) > 1
    ev, _, _ = make_bcd_evaluator("batched", tmodel, batch,
                                  {"params": tparams}, chunk_size=4, rt=6,
                                  device="cpu")
    np.testing.assert_array_equal(ev.evaluate(stacked), want)
    for fused in (False, True):
        ev, _, _ = make_bcd_evaluator("suffix", tmodel, batch,
                                      {"params": tparams}, chunk_size=4,
                                      rt=6, fused_kernels=fused,
                                      device="cpu")
        ev.begin_step(masks0)
        for _ in range(2):
            got = ev.evaluate(E.SitedChunk(site, stacked))
            np.testing.assert_array_equal(got, want)
        assert (ev.trie.misses, ev.trie.hits) == (1, 1)
        # a base edit below the cut keeps the cached prefix, one above it
        # drops it (per-repeat diff of the (R, F) stack mask)
        below, above = dict(masks0), dict(masks0)
        below["s0.ffn"] = masks0["s0.ffn"].copy()
        below["s0.ffn"][r, 0] = 0.0
        above["s0.ffn"] = masks0["s0.ffn"].copy()
        above["s0.ffn"][r - 1, 0] = 0.0
        ev.begin_step(below)
        assert len(ev.trie) == 1
        ev.begin_step(above)
        assert len(ev.trie) == 0


def test_params_from_reference_carries_lists_and_bfloat16():
    """The reference's LM tree has lists (``head``, ``tail``) and, at the
    configs' own dtype, bfloat16 leaves beside float32 norm scales."""
    from repro_torch import convert
    ref = reference()
    rcfg = ref.configs.get_config("gemma3_27b").reduced()   # a 2-block tail
    for dtype in ("float32", "bfloat16"):
        tree = to_numpy_tree(ref.lm.LM(dataclasses.replace(
            rcfg, dtype=dtype)).init(ref.jax.random.PRNGKey(0)))
        assert isinstance(tree["tail"], list) and len(tree["tail"]) == 2
        kept = convert.params_from_reference(tree, "cpu", dtype=None)
        f32 = convert.params_from_reference(tree, "cpu")
        assert isinstance(kept["tail"], list) and kept["head"] == []
        want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        assert kept["embed"].dtype == want_dt
        assert kept["tail"][1]["ffn"]["w_down"].dtype == want_dt
        assert kept["final_norm"]["scale"].dtype == torch.float32
        assert f32["embed"].dtype == torch.float32
        w = tree["stack"]["0"]["attn"]["wq"]
        np.testing.assert_array_equal(
            kept["stack"]["0"]["attn"]["wq"].float().numpy(),
            np.asarray(w, dtype=np.float32))
        np.testing.assert_array_equal(
            f32["stack"]["0"]["attn"]["wq"].numpy(),
            np.asarray(w, dtype=np.float32))


def test_unported_parts_raise_and_name_the_queue():
    """Every architecture builds (the MoE and hybrid blocks came with
    Queue A9), and sharded serving is ported (Queue A11,
    ``tests/test_torch_sharded_serve.py``), MoE and Mamba2 blocks split
    over ``"model"`` too (Queue A13); what still raises is a config whose
    expert columns or Mamba2 heads do not split over the ranks, and a
    mesh larger than the process group, which is never shrunk.  The
    sharded candidate engine (``tests/test_torch_sharded.py``) checks its
    arguments."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import Block
    from repro_torch.core import engine
    from repro_torch.launch import serve_loop
    from repro_torch.models.lm import LM
    for arch in ARCH_IDS:
        assert LM(get_config(arch).reduced()).relu_count() > 0
    with pytest.raises(ValueError, match="needs a device eval_fn"):
        engine.make_evaluator("sharded")
    m = LM(get_config("stablelm_1p6b").reduced())
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    store = serve_loop.threshold_mask_sets(m, [1.0], device="cpu")
    assert serve_loop.default_classes(store)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm as lm_lib
    import torch.distributed as dist
    for arch, change in (("deepseek_moe_16b", dict(d_ff_expert=30)),
                         ("zamba2_2p7b", dict(mamba_head_dim=64))):
        cfg = get_config(arch).reduced()
        lm_lib._check_tensor_parallel(cfg, 4)
        with pytest.raises(NotImplementedError, match="do not split"):
            lm_lib._check_tensor_parallel(
                dataclasses.replace(cfg, **change), 4)
    if not dist.is_initialized():
        with pytest.raises(ValueError, match="need 4 ranks, have 1"):
            mesh_lib.make_host_mesh(2, 2, device="cpu")
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(dataclasses.replace(get_config("stablelm_1p6b").reduced(),
                               pattern=(Block("conv"),)))
    # the KV cache is ported: a cached forward returns the logits and the
    # cache it wrote
    from repro_torch.core import linearize, masks as M
    masks = M.as_device(linearize.init_masks(m.mask_sites()), "cpu")
    cache = m.init_cache(1, 4, "cpu")
    logits, out = m.forward(params, masks,
                            torch.zeros(1, 2, dtype=torch.long), cache=cache)
    assert out is cache and logits.shape == (1, 2, m.cfg.vocab)


def test_lm_entry_points_default_to_the_card():
    import inspect
    from repro_torch.models import lm
    for fn in (lm.LM.init, lm.LM.make_eval_acc, lm.LM.make_param_eval_fn,
               lm.LM.make_eval_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
