"""The port's MoE and hybrid LMs against the JAX package's, on the CPU.

The configs are the reference's ``reduced()`` DeepSeek-MoE-16B (a dense head
block, then MoE blocks with a shared expert), Mixtral-8x22B (MoE blocks
with sliding-window attention, no shared expert) and Zamba2-2.7B (five
Mamba2 blocks and one shared attention block a repeat).  Parameters come
from the reference's ``LM(cfg).init`` and are converted with
``repro_torch.convert.params_from_reference``; tokens and masks are made
with numpy from a seed.  Under test: the site bookkeeping, logits stacked
and un-stacked, split forwards at cuts inside the stack, ``run_bcd``
through the four engines, the shared block's one parameter set, cached
prefill and decode, serving through ``generate`` and ``ServeLoop``, and the
full-size configs' sites.

Tolerance: 1e-4 absolute on logits, as ``tests/test_torch_lm.py``
(observed: a few 1e-6 for the MoE models, a few 1e-5 for Zamba2, whose
chunked scan divides by in-chunk decay products).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-4)
ARCHS = ["deepseek_moe_16b", "mixtral_8x22b", "zamba2_2p7b"]
B, S = 2, 12
_CACHE = {}


def _build(arch, dtype=None):
    """(ref, reference model, params, port model, converted params), the
    reduced config in both packages, cached per process."""
    key = (arch, dtype)
    if key in _CACHE:
        return _CACHE[key]
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    rcfg = ref.configs.get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu",
                                            dtype=None)
    _CACHE[key] = ref, rmodel, rparams, tmodel, tparams
    return _CACHE[key]


def _tokens(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)


def _dev(tree):
    from repro_torch.core import masks as M
    return M.as_device(tree, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_site_bookkeeping_equals_reference(arch):
    from repro_torch.core import linearize, masks as M
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    rs, ts = rmodel.mask_sites(), tmodel.mask_sites()
    assert list(rs) == list(ts)
    for k in rs:
        assert (rs[k].shape, rs[k].kind, rs[k].replacement) == \
            (ts[k].shape, ts[k].kind, ts[k].replacement)
    assert tmodel.relu_count() == \
        ref.masks.count(ref.linearize.init_masks(rs)) == \
        M.count(linearize.init_masks(ts))
    assert rmodel.site_order() == tmodel.site_order()
    assert rmodel.site_segments() == tmodel.site_segments()
    assert rmodel.site_repeats() == tmodel.site_repeats()
    for s in tmodel.site_segments():
        assert rmodel.suffix_sites(s) == tmodel.suffix_sites(s), s
    for seq in (64, 127, 512):
        assert rmodel.site_prefix_fractions(seq_len=seq) == \
            tmodel.site_prefix_fractions(seq_len=seq)
    # the port's own init makes the reference's tree (keys, shapes, dtypes)
    own = tmodel.init(torch.Generator().manual_seed(0), "cpu")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if isinstance(t, list):
            return [layout(v) for v in t]
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert layout(own) == layout(to_numpy_tree(rparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference_stacked_and_unstacked(arch):
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    toks = _tokens(tmodel.cfg, 1)
    x = torch.from_numpy(toks)
    trees = [random_masks(tmodel.mask_sites(), 3 + i) for i in range(3)]
    ones = []
    for tree in trees:
        want, _ = rmodel.forward(rparams, ref.masks.as_device(tree),
                                 ref.jnp.asarray(toks))
        got = tmodel.forward(tparams, _dev(tree), x)
        assert got.shape == (B, S, tmodel.cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        ones.append(got)
    stacked = _dev(M.stack_trees(trees))
    want_st = np.asarray(ref.jax.vmap(
        lambda m: rmodel.forward(rparams, m, ref.jnp.asarray(toks))[0])(
            ref.masks.as_device(M.stack_trees(trees))))
    for got_st in (tmodel.forward(tparams, stacked, x),
                   tmodel.forward(tparams, stacked, None,
                                  pre=tmodel.forward_pre(tparams, x))):
        assert got_st.shape == (3, B, S, tmodel.cfg.vocab)
        np.testing.assert_allclose(got_st.numpy(), want_st, **TOL)
        for i, one in enumerate(ones):
            np.testing.assert_allclose(got_st[i].numpy(), one.numpy(),
                                       rtol=0, atol=1e-5)


def test_fused_forward_matches_reference_fused_route():
    """DeepSeek's dense head block and shared experts under fused=True
    against the reference traced under ``fused_suffix_route(interpret=
    True)``, un-stacked and stacked; the routed experts stay on the gate
    route in both packages."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build("deepseek_moe_16b")
    toks = _tokens(tmodel.cfg, 5)
    trees = [random_masks(tmodel.mask_sites(), 6 + i) for i in range(2)]
    x, j = torch.from_numpy(toks), ref.jnp.asarray
    stacked = M.stack_trees(trees)
    with ref.linearize.fused_suffix_route(interpret=True):
        want = np.asarray(rmodel.forward(
            rparams, ref.masks.as_device(trees[0]), j(toks))[0])
        want_st = np.asarray(ref.jax.vmap(
            lambda m: rmodel.forward(rparams, m, j(toks))[0])(
                ref.masks.as_device(stacked)))
    got = tmodel.forward(tparams, _dev(trees[0]), x, fused=True, ties=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_st = tmodel.forward(tparams, _dev(stacked), x, fused=True,
                            ties=False)
    np.testing.assert_allclose(got_st.numpy(), want_st, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_suffix_at_cuts_inside_the_stack(arch):
    """prefix ∘ suffix == forward (the same fold, exactly), prefix_ext(a →
    b) == prefix(b), prefixes against the reference's, and the stacked
    suffix over the one shared prefix against full stacked forwards of the
    spliced trees, at every site of ``site_order`` (per-repeat cuts
    ``s<pos>.<suf>@r`` included)."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    toks = _tokens(tmodel.cfg, 7)
    x = torch.from_numpy(toks)
    trees = [random_masks(tmodel.mask_sites(), 8 + i) for i in range(3)]
    md, rmd = _dev(trees[0]), ref.masks.as_device(trees[0])
    full = tmodel.forward(tparams, md, x)
    stacked = _dev(M.stack_trees(trees[1:]))
    seg = tmodel.site_segments()
    prev_site, prev_cached = None, None
    assert any("@1" in s for s in tmodel.site_order())
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


def _greedy_batch(tmodel, tparams, seed, batch=4, seq=16, prompt=4):
    """Eval tokens whose labels after the prompt are the full-mask model's
    own greedy continuation, each forward at the full length (a MoE's
    capacity depends on the length)."""
    from repro_torch.core import linearize
    full = _dev(linearize.init_masks(tmodel.mask_sites()))
    toks = torch.from_numpy(_tokens(tmodel.cfg, seed, batch, seq + 1)).long()
    for t in range(prompt, seq + 1):
        nxt = tmodel.forward(tparams, full, toks[:, :-1])[:, t - 1]
        toks[:, t] = nxt.argmax(-1)
    return {"tokens": toks.to(torch.int32).numpy()}


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


@pytest.mark.parametrize("arch", ARCHS)
def test_run_bcd_selects_the_references_blocks(arch):
    """Greedy labels: the port's four engines select the reference's blocks
    with the same step logs as the reference's batched engine, whose
    trials do not all tie."""
    from repro_torch.core import bcd as Bc, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    batch = _greedy_batch(tmodel, tparams, seed=11)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    total = M.count(masks0)
    drc = 16
    kw = dict(b_target=total - 3 * drc, drc=drc, rt=6, adt=-100.0,
              finetune_every_step=False, seed=3, chunk_size=3,
              moves=("remove",))
    racc = rmodel.make_eval_acc(rparams, batch)
    ev = ref.engine.make_evaluator(
        "batched", eval_acc=racc,
        eval_fn=rmodel.make_eval_fn(rparams, batch), pad_to=3)
    want = ref.bcd.run_bcd(masks0, ref.bcd.BCDConfig(**kw), racc,
                           evaluator=ev, keep_snapshots=True)
    _assert_margins(tmodel, tparams, batch, want.mask_snapshots)
    assert len({h.best_drop for h in want.history}) > 1 or \
        any(h.best_drop != 0.0 for h in want.history)
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        ev, eval_acc, _ = make_bcd_evaluator(
            backend, tmodel, batch, {"params": tparams}, chunk_size=3, rt=6,
            prefetch=2, fused_kernels=True, device="cpu")
        got = Bc.run_bcd(masks0, Bc.BCDConfig(**kw), eval_acc, evaluator=ev)
        assert M.fingerprint(got.masks) == \
            ref.masks.fingerprint(want.masks), backend
        assert _logs(got.history) == _logs(want.history), backend


def test_shared_block_keeps_one_parameter_set():
    """Zamba2's attention block: one parameter set with no repeat axis in
    both packages (and in the port's own init), read by every repeat; its
    caches carry the repeat axis and hold each repeat's own keys."""
    from repro_torch.core import linearize
    ref, rmodel, rparams, tmodel, tparams = _build("zamba2_2p7b")
    cfg = tmodel.cfg
    pos = str(next(i for i, b in enumerate(cfg.pattern) if b.shared))
    d, hd = cfg.d_model, cfg.head_dim
    assert tuple(tparams["stack"][pos]["attn"]["wq"].shape) == \
        (d, cfg.n_heads * hd) == \
        np.asarray(rparams["stack"][pos]["attn"]["wq"]).shape
    assert tuple(tparams["stack"]["0"]["mamba"]["w_z"].shape) == \
        (cfg.n_repeats, d, cfg.d_inner)
    own = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    assert own["stack"][pos]["attn"]["wq"].shape == (d, cfg.n_heads * hd)
    # the forward reads the one tensor: a change to it moves the logits
    x = torch.from_numpy(_tokens(cfg, 2))
    masks = _dev(linearize.init_masks(tmodel.mask_sites()))
    before = tmodel.forward(tparams, masks, x)
    p2 = dict(tparams, stack=dict(tparams["stack"]))
    p2["stack"][pos] = {**tparams["stack"][pos],
                        "attn": {**tparams["stack"][pos]["attn"],
                                 "wo": tparams["stack"][pos]["attn"]["wo"]
                                 * 2}}
    assert not torch.allclose(tmodel.forward(p2, masks, x), before)
    cache = tmodel.init_cache(1, 8, "cpu")
    K = cache["stack"][pos]["kv"][0]
    assert K.shape == (cfg.n_repeats, 1, 8, cfg.n_kv_heads, hd)
    tmodel.forward(tparams, masks, x[:1, :4], cache=cache)
    assert not torch.equal(K[0, :, :4], K[1, :, :4])


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_decode_match_reference(arch):
    """A prefill of 8 tokens and 8 decode steps: each step's logits against
    the reference's cached forward, and all of them against the uncached
    forward of the 16 tokens (the reference's
    ``test_decode_matches_full_forward``; at 16 tokens a reduced MoE has
    16 slots an expert, so nothing is dropped, and at 8 it has 8)."""
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    tree = random_masks(tmodel.mask_sites(), 2, density=0.8)
    toks = _tokens(cfg, 1, 2, 16)
    j, rm, tm = ref.jnp.asarray, ref.masks.as_device(tree), _dev(tree)
    rc = rmodel.init_cache(2, 16)
    tc = tmodel.init_cache(2, 16, "cpu")
    rl, rc = rmodel.forward(rparams, rm, j(toks[:, :8]), cache=rc,
                            cache_len=0)
    tl, tc2 = tmodel.forward(tparams, tm, torch.from_numpy(toks[:, :8]),
                             cache=tc)
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    outs = [tl]
    for t in range(8, 16):
        rl, rc = rmodel.forward(rparams, rm, j(toks[:, t:t + 1]), cache=rc,
                                cache_len=t)
        tl, _ = tmodel.forward(tparams, tm,
                               torch.from_numpy(toks[:, t:t + 1]), cache=tc,
                               cache_len=t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        outs.append(tl)
    full = tmodel.forward(tparams, tm, torch.from_numpy(toks))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_serve_loop_serve_the_new_kinds(arch):
    """``launch.serve.generate`` (a batched prefill, then decode steps: a
    MoE at one slot an expert, Mamba2 on the exact recurrence) equals the
    reference's prefill and decode step, and an exact-length ``ServeLoop``
    serves every request with the tokens ``generate`` gives that prompt
    alone."""
    from repro_torch.launch import serve, serve_loop
    ref, rmodel, rparams, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    tree = random_masks(tmodel.mask_sites(), 4, density=0.8)
    prompts = _tokens(cfg, 3, 2, 6)
    out = serve.generate(tmodel, tparams, _dev(tree),
                         torch.from_numpy(prompts), 5, keep_logits=True)
    j, rm = ref.jnp.asarray, ref.masks.as_device(tree)
    rlast, rc = ref.serve.make_prefill(rmodel)(
        rparams, rm, j(prompts), rmodel.init_cache(2, 11))
    step = ref.serve.make_decode_step(rmodel)
    tok = np.asarray(rlast).argmax(-1)[:, None].astype(np.int32)
    want = [tok[:, 0]]
    np.testing.assert_allclose(out["logits"][0].numpy(), np.asarray(rlast),
                               **TOL)
    for t in range(4):
        nxt, rc = step(rparams, rm, j(tok), rc, 6 + t)
        tok = np.asarray(nxt)
        want.append(tok[:, 0])
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))
    store = serve_loop.threshold_mask_sets(tmodel, [1.0, 0.5], seed=0,
                                           device="cpu")
    classes = [serve_loop.SLOClass(f"c{i}", n, 4)
               for i, n in enumerate(store.names)]
    loop = serve_loop.ServeLoop(tmodel, tparams, store, classes, slots=2,
                                max_len=16, prompt_bucket=None, device="cpu")
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, cfg.vocab, n) for n in (3, 7, 5, 9)]
    reqs = [loop.submit(p, classes[i % 2].name) for i, p in enumerate(ps)]
    loop.shutdown(drain=True)
    assert [r.state for r in reqs] == ["served"] * 4
    for r, p in zip(reqs, ps):
        alone = serve.generate(tmodel, tparams, store.select(r.mask_set),
                               torch.from_numpy(p[None]), 4)
        assert r.tokens == alone["tokens"][0].tolist(), r.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_configs_build(arch):
    """``LM(get_config(arch))`` builds at the published widths; the sites
    and counts are the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    m = LM(get_config(arch))
    rm = ref.lm.LM(ref.configs.get_config(arch))
    assert list(m.mask_sites()) == list(rm.mask_sites())
    assert m.site_order() == rm.site_order()
    assert m.relu_count() == ref.masks.count(
        ref.linearize.init_masks(rm.mask_sites()))
    want = {"deepseek_moe_16b": 10944 + 27 * (64 * 1408 + 2816),
            "mixtral_8x22b": 56 * 8 * 16384,
            "zamba2_2p7b": 45 * 5120}[arch]
    assert m.relu_count() == want


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "zamba2_2p7b"])
def test_params_from_reference_carries_the_new_trees(arch):
    """At the configs' own bfloat16: ``dtype=None`` keeps the float32
    leaves (the router; ``dt_bias``, ``A_log``, ``D``) beside bfloat16
    weights, and the shared block's entry has no repeat axis."""
    from repro_torch import convert
    ref = reference()
    rcfg = ref.configs.get_config(arch).reduced()
    tree = to_numpy_tree(ref.lm.LM(dataclasses.replace(
        rcfg, dtype="bfloat16")).init(ref.jax.random.PRNGKey(0)))
    kept = convert.params_from_reference(tree, "cpu", dtype=None)
    R = rcfg.n_repeats
    if arch == "deepseek_moe_16b":
        m = kept["stack"]["0"]["moe"]
        assert m["router"].dtype == torch.float32
        assert m["w_gate"].dtype == torch.bfloat16
        assert tuple(m["w_gate"].shape) == (R, 4, 64, 32)
        assert m["shared"]["w_down"].dtype == torch.bfloat16
        assert kept["head"][0]["ffn"]["w_up"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            m["router"].numpy(), tree["stack"]["0"]["moe"]["router"])
    else:
        m = kept["stack"]["0"]["mamba"]
        for k in ("dt_bias", "A_log", "D"):
            assert m[k].dtype == torch.float32 and m[k].shape[0] == R
        assert m["w_x"].dtype == torch.bfloat16
        attn = kept["stack"]["5"]["attn"]
        assert attn["wq"].dtype == torch.bfloat16 and attn["wq"].dim() == 2
        np.testing.assert_array_equal(
            attn["wq"].float().numpy(),
            tree["stack"]["5"]["attn"]["wq"].astype(np.float32))
