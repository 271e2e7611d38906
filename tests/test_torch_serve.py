"""The port's serving primitives against the JAX package's, on the CPU.

Parameters come from the reference's ``LM(cfg).init`` converted with
``repro_torch.convert.params_from_reference``; tokens and masks are made
with numpy from a seed.  Under test:

- cached prefill + decode (``training.serve.make_prefill``,
  ``make_decode_step``, ``LM.forward(cache=, cache_len=)``) give the
  reference's logits within 1e-4 on the six reduced dense configs of
  ``tests/test_torch_lm.py``, ``gemma3_27b`` with a 3-token sliding window
  and reduced ``rwkv6_3b``, with a scalar ``cache_len`` and with a ragged
  ``(B,)`` one (slots filled by ``make_insert_slot`` from B=1 prefills),
  and on reduced ``deepseek_moe_16b``, ``mixtral_8x22b`` and
  ``zamba2_2p7b`` (MoE decode steps, Mamba2 states, the shared attention
  block's per-repeat KV caches);
- cached against uncached, in the port itself;
- ``make_insert_slot`` copies, never aliases, and a refilled slot does not
  see its previous occupant;
- ``MaskSetStore``: views, layout errors, ``verify``, ``cheaper_sets``,
  ``pi_cost_per_token`` equal to the reference's, and ``from_run_dir``
  over run directories written by either package;
- RWKV-6 prompt lengths that the reference's chunk rule refuses are
  refused by the port as well.

Tolerance: 1e-4 absolute on logits, as ``tests/test_torch_lm.py`` (the
observed differences are a few 1e-6: sums in other orders).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_helpers import (cast_floats, float64_torch, random_masks,
                                reference, to_numpy_tree, tree_leaves)

TOL = dict(rtol=0.0, atol=1e-4)
ARCHS = ["stablelm_1p6b", "qwen3_32b", "gemma3_27b", "mistral_nemo_12b",
         "musicgen_large", "paligemma_3b", "gemma3_27b@window3", "rwkv6_3b",
         "deepseek_moe_16b", "mixtral_8x22b", "zamba2_2p7b"]
MAX_LEN = 24
_CACHE = {}


def _build(arch):
    """(ref, reference model, params, jitted reference forward, port model,
    converted params), cached per process."""
    if arch in _CACHE:
        return _CACHE[arch]
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    name, _, w = arch.partition("@window")
    rcfg = ref.configs.get_config(name).reduced()
    tcfg = get_config(name).reduced()
    if w:
        def win(cfg):
            pat = tuple(dataclasses.replace(b, window=int(w))
                        for b in cfg.pattern)
            return dataclasses.replace(cfg, pattern=pat)
        rcfg, tcfg = win(rcfg), win(tcfg)
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu")
    fwd = ref.jax.jit(lambda p, m, t, c, cl, pe=None: rmodel.forward(
        p, m, t, cache=c, cache_len=cl, prefix_embeds=pe))
    _CACHE[arch] = ref, rmodel, rparams, fwd, tmodel, tparams
    return _CACHE[arch]


def _dev(tree):
    from repro_torch.core import masks as M
    return M.as_device(tree, "cpu")


def _tokens(vocab, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=shape).astype(np.int32)


# ------------------------------------------------ cached against the ref

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference_scalar_cache_len(arch):
    """A batched prefill (make_prefill; paligemma with its prefix
    embeddings) and four greedy decode steps at one shared cache_len."""
    from repro_torch.training import serve
    ref, rmodel, rparams, fwd, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    B, P = 2, 8
    toks = _tokens(cfg.vocab, 1, (B, P))
    tree = random_masks(tmodel.mask_sites(), 2)
    pe = None
    if cfg.prefix_len:
        pe = np.random.default_rng(3).normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    j, rm = ref.jnp.asarray, ref.masks.as_device(tree)
    rlast, rcache = ref.serve.make_prefill(rmodel)(
        rparams, rm, j(toks), rmodel.init_cache(B, MAX_LEN),
        prefix_embeds=None if pe is None else j(pe))
    tcache = tmodel.init_cache(B, MAX_LEN, "cpu")
    tlast, tcache2 = serve.make_prefill(tmodel)(
        tparams, _dev(tree), torch.from_numpy(toks), tcache,
        prefix_embeds=None if pe is None else torch.from_numpy(pe))
    assert tcache2 is tcache                      # written in place
    np.testing.assert_allclose(tlast.numpy(), np.asarray(rlast), **TOL)
    tok = np.asarray(rlast).argmax(-1)[:, None].astype(np.int32)
    rstep = ref.serve.make_decode_step(rmodel)
    tstep = serve.make_decode_step(tmodel)
    start = P + cfg.prefix_len
    for t in range(4):
        rl, rcache_next = fwd(rparams, rm, j(tok), rcache, start + t)
        rnxt, _ = rstep(rparams, rm, j(tok), rcache, start + t)
        tnxt, tcache, tl = tstep(tparams, _dev(tree), torch.from_numpy(tok),
                                 tcache, start + t)
        rcache = rcache_next
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl)[:, -1], **TOL)
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(rnxt))
        tok = np.array(rnxt)
    _assert_caches_close(tcache, rcache)


def _assert_caches_close(tcache, rcache):
    """The port's cache tree against the reference's: same structure,
    leaves within the logit tolerance."""
    if isinstance(rcache, dict):
        assert set(tcache) == set(rcache)
        for k in rcache:
            _assert_caches_close(tcache[k], rcache[k])
    elif isinstance(rcache, (list, tuple)):
        assert len(tcache) == len(rcache)
        for a, b in zip(tcache, rcache):
            _assert_caches_close(a, b)
    else:
        b = np.asarray(rcache)
        assert tuple(tcache.shape) == b.shape
        np.testing.assert_allclose(tcache.float().numpy(),
                                   b.astype(np.float32), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_decode_matches_reference_vector_cache_len(arch):
    """Continuous batching: two prompts of 5 and 9 tokens prefilled at B=1
    and inserted into slots 1 and 0 of a B=2 cache (make_insert_slot, both
    packages), then four decode steps at per-slot positions."""
    from repro_torch.training import serve
    ref, rmodel, rparams, fwd, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    tree = random_masks(tmodel.mask_sites(), 4)
    j, rm, tm = ref.jnp.asarray, ref.masks.as_device(tree), _dev(tree)
    prompts = {1: _tokens(cfg.vocab, 5, (1, 5)),
               0: _tokens(cfg.vocab, 6, (1, 9))}
    rbig = rmodel.init_cache(2, MAX_LEN)
    tbig = tmodel.init_cache(2, MAX_LEN, "cpu")
    rins = ref.serve.make_insert_slot(rmodel)
    tins = serve.make_insert_slot(tmodel)
    tok = np.zeros((2, 1), np.int32)
    cl = np.zeros((2,), np.int32)
    for slot, p in prompts.items():
        rl, rsmall = fwd(rparams, rm, j(p), rmodel.init_cache(1, MAX_LEN), 0)
        tl, tsmall = tmodel.forward(tparams, tm, torch.from_numpy(p),
                                    cache=tmodel.init_cache(1, MAX_LEN,
                                                            "cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        rbig = rins(rbig, rsmall, j(slot))
        assert tins(tbig, tsmall, slot) is tbig
        tok[slot, 0] = int(np.asarray(rl)[0, -1].argmax())
        cl[slot] = p.shape[1]
    _assert_caches_close(tbig, rbig)
    for _ in range(4):
        rl, rbig = fwd(rparams, rm, j(tok), rbig, j(cl))
        tl, tbig = tmodel.forward(tparams, tm, torch.from_numpy(tok),
                                  cache=tbig, cache_len=cl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        tok = np.asarray(rl)[:, -1:].argmax(-1).astype(np.int32)
        cl = cl + 1
    _assert_caches_close(tbig, rbig)


# ----------------------------------- the one-process distance, and float64

def _cached_logits(forward, cache, toks, feed, start):
    """A prefill of ``toks``, then one decode step a token of ``feed``
    ((B, 1) each), or, where ``feed`` is an empty list, four greedy steps
    whose tokens are appended to it: every forward's last logits,
    float64, ``(1 + steps, B, V)``."""
    greedy = not feed
    lg, cache = forward(toks, cache, 0)
    out = [np.asarray(lg)[:, -1].astype(np.float64)]
    for t in range(4 if greedy else len(feed)):
        if greedy:
            feed.append(out[-1].argmax(-1)[:, None].astype(np.int32))
        lg, cache = forward(feed[t], cache, start + t)
        out.append(np.asarray(lg)[:, -1].astype(np.float64))
    return np.stack(out)


@pytest.fixture
def one_thread():
    """One intra-op thread for many tiny forwards: under a parallel run the
    workers share the cores, and a pool of threads a worker waits on
    itself.  Put back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (arch, the reference's own distance from float64 above or below 1e-5)
_FLOAT64_CASES = [("stablelm_1p6b", False), ("zamba2_2p7b", True)]
# mask seeds: each is one draw of both packages' float32 rounding
FLOAT64_SEEDS = range(64)


@pytest.mark.parametrize("arch,deep", _FLOAT64_CASES)
def test_one_process_distance_is_the_references_own_rounding(monkeypatch,
                                                             one_thread,
                                                             arch, deep):
    """Queue C 9, closed.  Reduced Zamba2's cached logits sit up to 3.1e-5
    from the reference's, where the dense families' sit within 1e-5,
    because its 12 blocks (a dense family's reduced config has 2) compound
    float32 rounding in both packages.  Against a float64 evaluation of
    the same function (the port's plain path, parameters and upcasts in
    float64), over ``FLOAT64_SEEDS`` mask seeds, the port's logits are on
    the average no farther than the reference's, by their largest and by
    their root-mean-square distance: each mean exceeds the reference's by
    at most 3 standard errors of the paired, seed by seed, difference.
    One seed is one draw of the rounding: for Zamba2 the port's largest
    distance is past the reference's on 34 of the 64 seeds and short of
    it on 30, by up to 3.1e-5 and 2.2e-5, so no bound seed by seed holds
    below the distances themselves; the means read 1.770e-5 against
    1.719e-5 (+0.56 standard errors) and 3.66e-6 against 3.71e-6 for the
    root mean square (-0.50).  A port whose Mamba2 scan output drops its
    3 low bits reads +3.80 and fails; 2 bits, +2.55, pass.  Each block's
    own rounding is ~1e-6 alike in both packages (ROADMAP, Queue C 9).
    And the reference's own mean distance is past 1e-5 for Zamba2 alone."""
    ref, rmodel, rparams, fwd, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    B, P = 2, 8
    toks = _tokens(cfg.vocab, 1, (B, P))
    j = ref.jnp.asarray
    runs = []
    for seed in FLOAT64_SEEDS:
        tree, feed = random_masks(tmodel.mask_sites(), seed), []
        rm = ref.masks.as_device(tree)
        want = _cached_logits(
            lambda t, c, cl: fwd(rparams, rm, j(t), c, cl),
            rmodel.init_cache(B, MAX_LEN), toks, feed, P)
        runs.append((tree, feed, want))

    def port(params, cache, tree, feed):
        with torch.no_grad():
            return _cached_logits(
                lambda t, c, cl: tmodel.forward(
                    params, _dev(tree), torch.from_numpy(t), cache=c,
                    cache_len=cl), cache, toks, feed, P)
    got = [port(tparams, tmodel.init_cache(B, MAX_LEN, "cpu"), tree, feed)
           for tree, feed, _ in runs]
    modules, f64 = float64_torch()
    for mod in modules:
        monkeypatch.setattr(mod, "torch", f64)
    params64 = cast_floats(tparams, torch.float64)
    errs = []         # (seed, reference / port, largest / rms)
    for (tree, feed, want), g in zip(runs, got):
        exact = port(params64, cast_floats(
            tmodel.init_cache(B, MAX_LEN, "cpu"), torch.float64), tree, feed)
        assert float(np.abs(g - want).max()) <= TOL["atol"]
        errs.append([[np.abs(e).max(), np.sqrt(np.mean(e * e))]
                     for e in (want - exact, g - exact)])
    errs = np.array(errs).transpose(2, 1, 0)  # (stat, package, seed)
    for stat, (ref_err, port_err) in zip(("largest", "rms"), errs):
        diff = port_err - ref_err
        se = float(diff.std(ddof=1)) / np.sqrt(len(diff))
        assert diff.mean() <= 3 * se, (stat, port_err.mean(),
                                       ref_err.mean(), se)
    assert (errs[0, 0].mean() > 1e-5) == deep, errs[0, 0].mean()


# ------------------------------------------------ cached against uncached

@pytest.mark.parametrize("arch", ["stablelm_1p6b", "gemma3_27b@window3",
                                  "musicgen_large", "rwkv6_3b"])
def test_cached_equals_uncached_forward(arch):
    """Prefill then decode, each step's logits against the uncached forward
    of the whole sequence so far, at its last position."""
    from repro_torch.launch import serve
    _, _, _, _, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    masks = _dev(random_masks(tmodel.mask_sites(), 7))
    prompts = torch.from_numpy(_tokens(cfg.vocab, 8, (3, 8)))
    out = serve.generate(tmodel, tparams, masks, prompts, 6,
                         keep_logits=True)
    seq = torch.cat([prompts, out["tokens"].to(prompts.dtype)], dim=1)
    for t, logits in enumerate(out["logits"]):
        n = 8 + t
        full = tmodel.forward(tparams, masks, seq[:, :n])
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                                   **TOL)
        assert torch.equal(out["tokens"][:, t],
                           logits.argmax(-1).to(torch.int32))


def test_uncached_forward_returns_logits_alone():
    """The eval contract is unchanged: no cache, no tuple."""
    _, _, _, _, tmodel, tparams = _build("stablelm_1p6b")
    masks = _dev(random_masks(tmodel.mask_sites(), 1))
    out = tmodel.forward(tparams, masks, torch.zeros((1, 4),
                                                     dtype=torch.int32))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 4, 128)


def test_cache_refusals():
    """Stacked candidates and a write past the cache raise."""
    from repro_torch.core import masks as M
    _, _, _, _, tmodel, tparams = _build("stablelm_1p6b")
    tree = random_masks(tmodel.mask_sites(), 1)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="not a stack"):
        tmodel.forward(tparams, _dev(M.stack_trees([tree, tree])), toks,
                       cache=tmodel.init_cache(1, 8, "cpu"))
    with pytest.raises(ValueError, match="exceed"):
        tmodel.forward(tparams, _dev(tree), toks,
                       cache=tmodel.init_cache(1, 8, "cpu"), cache_len=6)
    with pytest.raises(ValueError, match="cache_len must be"):
        tmodel.forward(tparams, _dev(tree), toks,
                       cache=tmodel.init_cache(1, 8, "cpu"),
                       cache_len=np.array([0, 1]))


def test_init_cache_tree_equals_reference():
    """Same keys, nesting, shapes and dtypes as the reference's cache, and
    every leaf a tensor of its own."""
    for arch in ("stablelm_1p6b", "rwkv6_3b", "deepseek_moe_16b",
                 "zamba2_2p7b"):
        ref, rmodel, _, _, tmodel, _ = _build(arch)
        rc = ref.jax.tree.map(np.asarray, rmodel.init_cache(3, 10))
        tc = tmodel.init_cache(3, 10, "cpu")
        _assert_caches_close(tc, rc)
        leaves = tree_leaves(tc)
        assert len({t.data_ptr() for t in leaves}) == len(leaves)
        assert {str(t.dtype) for t in leaves} == {"torch.float32"}


# ------------------------------------------------------------ slot surgery

@pytest.mark.parametrize("arch", ["stablelm_1p6b", "rwkv6_3b",
                                  "deepseek_moe_16b", "zamba2_2p7b"])
def test_insert_slot_copies_and_a_reused_slot_forgets(arch):
    """Inserting copies (the B=1 cache can be zeroed and refilled without
    touching the lane), and a slot refilled after a finish decodes exactly
    as it does in a fresh cache: it never sees the previous occupant."""
    from repro_torch.training import serve
    _, _, _, _, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    masks = _dev(random_masks(tmodel.mask_sites(), 9))
    insert = serve.make_insert_slot(tmodel)
    step = serve.make_decode_step(tmodel)

    def prefill(p):
        small = tmodel.init_cache(1, MAX_LEN, "cpu")
        logits, small = tmodel.forward(tparams, masks, torch.from_numpy(p),
                                       cache=small)
        return int(logits[0, -1].argmax()), small

    def decode(big, tok, cl, n=3):
        out = []
        for _ in range(n):
            nxt, big, _ = step(tparams, masks, torch.from_numpy(tok), big,
                               cl)
            tok, cl = nxt.numpy(), cl + 1
            out.append(tok.reshape(-1).tolist())
        return out

    long_p, short_p = (_tokens(cfg.vocab, s, (1, n))
                       for s, n in ((10, 12), (11, 4)))
    # slot 0 first serves the long prompt, then the short one
    big = tmodel.init_cache(2, MAX_LEN, "cpu")
    first, small = prefill(long_p)
    insert(big, small, 0)
    before = [t.clone() for t in tree_leaves(big)]
    for t in tree_leaves(small):
        t.zero_()                         # the prefill cache is reused
    for a, b in zip(before, tree_leaves(big)):
        assert torch.equal(a, b)
    decode(big, np.array([[first], [0]], np.int32), np.array([12, 0]))
    second, small = prefill(short_p)
    insert(big, small, 0)
    reused = decode(big, np.array([[second], [0]], np.int32),
                    np.array([4, 0]))
    fresh = tmodel.init_cache(2, MAX_LEN, "cpu")
    insert(fresh, prefill(short_p)[1], 0)
    # slot 0's stream; slot 1 holds no request
    assert [row[0] for row in reused] == \
        [row[0] for row in decode(fresh, np.array([[second], [0]], np.int32),
                                  np.array([4, 0]))]


def test_read_slot_tokens():
    from repro_torch.training import serve
    live = np.array([True, False, True])
    got = serve.read_slot_tokens(torch.tensor([[4], [5], [6]]), live)
    np.testing.assert_array_equal(got, [4, -1, 6])
    np.testing.assert_array_equal(
        got, reference().serve.read_slot_tokens(np.array([[4], [5], [6]]),
                                                live))


# ------------------------------------------------------------ MaskSetStore

SHAPES = {"a": (6,), "b": (2, 4)}


def _sets():
    from repro_torch.core import masks as M
    rng = np.random.default_rng(0)
    full = M.full_masks(SHAPES)
    soft = {k: rng.random(v.shape).astype(np.float32)
            for k, v in full.items()}
    total = M.count(full)
    return {"hi": M.threshold(soft, total),
            "mid": M.threshold(soft, 2 * total // 3),
            "lo": M.threshold(soft, total // 2)}


def _stores(sets=None):
    from repro_torch.training import serve
    sets = sets or _sets()
    return (serve.MaskSetStore(SHAPES, sets, device="cpu"),
            reference().serve.MaskSetStore(SHAPES, sets))


def test_store_selects_views_and_matches_reference():
    from repro_torch.core import masks as M
    store, rstore = _stores()
    sets = _sets()
    assert store.names == rstore.names == ("hi", "mid", "lo")
    for name in store.names:
        sel = store.select(name)
        assert set(sel) == set(SHAPES)
        for k, v in sel.items():
            assert isinstance(v, torch.Tensor) and tuple(v.shape) == SHAPES[k]
            # a view of the resident stack: switching budgets copies nothing
            assert v.untyped_storage().data_ptr() == \
                store._stacked[k].untyped_storage().data_ptr()
            np.testing.assert_array_equal(v.numpy(), sets[name][k])
        assert store.info(name) == store.info(name)
        assert dataclasses.asdict(store.info(name)) == \
            dataclasses.asdict(rstore.info(name))
        assert store.info(name).relu_cost == M.relu_cost(sets[name])
        assert store.cheaper_sets(name) == rstore.cheaper_sets(name)
        assert store.pi_cost_per_token(name) == \
            _as_port_cost(rstore.pi_cost_per_token(name))
        h = store.host(name)
        h["a"][:] = 7                     # a copy
        assert store.verify(name) == rstore.verify(name)
    assert store.cheaper_sets("hi") == ("mid", "lo")


def _as_port_cost(c):
    from repro_torch.core import pi_cost
    return pi_cost.PICost(**dataclasses.asdict(c))


def test_store_pi_cost_under_another_protocol():
    from repro_torch.core import pi_cost
    store, rstore = _stores()
    wan = dict(bandwidth_bytes_per_s=12.5e6, rtt_s=0.0)
    for name in store.names:
        assert store.pi_cost_per_token(name, pi_cost.PIProtocol(**wan)) == \
            _as_port_cost(rstore.pi_cost_per_token(
                name, reference().pi_cost.PIProtocol(**wan)))


def test_store_verify_refuses_a_corrupt_fingerprint():
    from repro_torch.launch import faults
    from repro_torch.training import serve
    store, rstore = _stores()
    fp = store.info("lo").fingerprint
    bad = faults.corrupt_fingerprint(fp)
    with pytest.raises(serve.MaskSetError, match="fails fingerprint"):
        store.verify("lo", observed=bad)
    with pytest.raises(reference().serve.MaskSetError,
                       match="fails fingerprint"):
        rstore.verify("lo", observed=bad)
    assert store.verify("lo", observed=fp) == fp


def test_store_rejects_layout_mismatch():
    from repro_torch.training import serve
    good = _sets()["hi"]
    for bad, needle in [
            ({"a": good["a"]}, "missing site 'b'"),
            ({**good, "c": np.ones(3, np.float32)}, "unknown site 'c'"),
            ({**good, "a": np.ones(7, np.float32)}, "model wants (6,)")]:
        with pytest.raises(serve.MaskSetError, match="site layout"):
            serve.MaskSetStore(SHAPES, {"x": bad}, device="cpu")
        problems = serve.validate_site_layout(SHAPES, bad)
        assert any(needle in p for p in problems), (needle, problems)
        assert problems == reference().serve.validate_site_layout(SHAPES,
                                                                  bad)
    with pytest.raises(serve.MaskSetError, match="at least one"):
        serve.MaskSetStore(SHAPES, {}, device="cpu")


def _lm_sets(seed=0):
    """Two budgets over the reduced StableLM's site layout."""
    from repro_torch.core import masks as M
    _, _, _, _, tmodel, _ = _build("stablelm_1p6b")
    shapes = {k: s.shape for k, s in tmodel.mask_sites().items()}
    full = M.full_masks(shapes)
    rng = np.random.default_rng(seed)
    soft = {k: rng.random(v.shape).astype(np.float32)
            for k, v in full.items()}
    return shapes, {"b192": M.threshold(soft, 192),
                    "b96": M.threshold(soft, 96)}


def _save_stage(writer, run_dir, name, masks):
    d = os.path.join(run_dir, name, "final")
    if writer == "port":
        from repro_torch.core import runner
        runner.save_stage_init(d, {"kind": "bcd", "masks": masks})
    else:
        reference().runner.save_stage_init(d, {"kind": "bcd",
                                               "masks": masks})
    return d


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_from_run_dir_loads_and_fingerprints(tmp_path, writer):
    """A run dir of stage inits over a reduced LM's site layout, written by
    either package, loads in the port as in the reference."""
    from repro_torch.training import serve
    shapes, sets = _lm_sets()
    run = str(tmp_path)
    _save_stage(writer, run, "stage_00_b192", sets["b192"])
    _save_stage(writer, run, "stage_01_b96", sets["b96"])
    store = serve.MaskSetStore.from_run_dir(run, shapes, device="cpu")
    rstore = reference().serve.MaskSetStore.from_run_dir(run, shapes)
    assert store.names == rstore.names == ("b192", "b96")
    for name in store.names:
        assert dataclasses.asdict(store.info(name)) == \
            dataclasses.asdict(rstore.info(name))
        for k in shapes:
            np.testing.assert_array_equal(store.host(name)[k],
                                          sets[name][k])
        assert store.info(name).source.endswith("final")
    only = serve.MaskSetStore.from_run_dir(run, shapes, names=["b96"],
                                           device="cpu")
    assert only.names == ("b96",)
    with pytest.raises(serve.MaskSetError, match="not found"):
        serve.MaskSetStore.from_run_dir(run, shapes, names=["b999"],
                                        device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_from_run_dir_rejects_tampering(tmp_path, writer):
    """A mask leaf overwritten after its manifest (sha256 mismatch), and a
    manifest whose recorded mask fingerprint was edited: both refused."""
    import json
    from repro_torch.core import runner
    from repro_torch.training import serve
    shapes, sets = _lm_sets(1)
    final = _save_stage(writer, str(tmp_path / "leaf"), "stage_00_b192",
                        sets["b192"])
    step = os.path.join(final, "step_00000000")
    leaf = sorted(f for f in os.listdir(step) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(step, leaf))
    np.save(os.path.join(step, leaf), np.zeros_like(arr))
    from repro_torch.core import masks as M
    with pytest.raises(runner.CheckpointError):
        runner.load_stage_init(final, M.full_masks(shapes), masks_only=True,
                               device="cpu")
    with pytest.raises(serve.MaskSetError, match="cannot be loaded"):
        serve.MaskSetStore.from_run_dir(str(tmp_path / "leaf"), shapes,
                                        device="cpu")

    final = _save_stage(writer, str(tmp_path / "meta"), "stage_00_b192",
                        sets["b192"])
    step = os.path.join(final, "step_00000000")
    man = [f for f in os.listdir(step) if f.endswith(".json")][0]
    with open(os.path.join(step, man)) as f:
        doc = json.load(f)
    doc["meta"]["mask_fingerprint"] = "f" * 64
    with open(os.path.join(step, man), "w") as f:
        json.dump(doc, f)
    with pytest.raises(serve.MaskSetError, match="fails fingerprint"):
        serve.MaskSetStore.from_run_dir(str(tmp_path / "meta"), shapes,
                                        device="cpu")
    with pytest.raises(reference().serve.MaskSetError,
                       match="fails fingerprint"):
        reference().serve.MaskSetStore.from_run_dir(str(tmp_path / "meta"),
                                                    shapes)


def test_store_from_run_dir_rejects_wrong_layout_and_empty(tmp_path):
    from repro_torch.training import serve
    shapes, sets = _lm_sets()
    other = {k: v for k, v in sets["b96"].items() if k != "s0.ffn"}
    _save_stage("port", str(tmp_path / "w"), "stage_00_b17", other)
    with pytest.raises(serve.MaskSetError, match="mismatch|different"):
        serve.MaskSetStore.from_run_dir(str(tmp_path / "w"), shapes,
                                        device="cpu")
    with pytest.raises(serve.MaskSetError, match="no completed sweep"):
        serve.MaskSetStore.from_run_dir(str(tmp_path / "empty"), shapes,
                                        device="cpu")


# ------------------------------------------------ RWKV-6's chunk rule

@pytest.mark.parametrize("length", [33, 40, 63])
def test_rwkv_prompt_lengths_both_packages_refuse(length):
    """Above 32 tokens the scan chunk is 32 and the prompt must be a
    multiple of it: the reference's linattn_chunked cannot reshape, and
    the port refuses the same lengths instead of padding."""
    from repro_torch.training import serve
    ref, rmodel, rparams, _, tmodel, tparams = _build("rwkv6_3b")
    tree = random_masks(tmodel.mask_sites(), 1)
    toks = _tokens(tmodel.cfg.vocab, length, (1, length))
    with pytest.raises((TypeError, ValueError)):
        ref.serve.make_prefill(rmodel)(
            rparams, ref.masks.as_device(tree), ref.jnp.asarray(toks),
            rmodel.init_cache(1, 64))
    with pytest.raises(ValueError, match="not a multiple of the scan"):
        serve.make_prefill(tmodel)(tparams, _dev(tree),
                                   torch.from_numpy(toks),
                                   tmodel.init_cache(1, 64, "cpu"))


@pytest.mark.parametrize("length", [1, 20, 32, 64])
def test_rwkv_prompt_lengths_both_packages_accept(length):
    """One token takes the decode step's recurrence; up to 32 one chunk;
    multiples of 32 several: both packages agree on the logits."""
    from repro_torch.training import serve
    ref, rmodel, rparams, _, tmodel, tparams = _build("rwkv6_3b")
    tree = random_masks(tmodel.mask_sites(), 2)
    toks = _tokens(tmodel.cfg.vocab, length, (2, length))
    rlast, rc = ref.serve.make_prefill(rmodel)(
        rparams, ref.masks.as_device(tree), ref.jnp.asarray(toks),
        rmodel.init_cache(2, 64))
    tlast, tc = serve.make_prefill(tmodel)(
        tparams, _dev(tree), torch.from_numpy(toks),
        tmodel.init_cache(2, 64, "cpu"))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(rlast), **TOL)
    _assert_caches_close(tc, rc)


# ------------------------------------------------------------ entry points

def test_serving_entry_points_default_to_the_card():
    import inspect
    from repro_torch.launch import serve_loop
    from repro_torch.models.lm import LM
    from repro_torch.training import serve
    for fn in (LM.init_cache, serve.MaskSetStore.__init__,
               serve.MaskSetStore.from_run_dir, serve_loop.ServeLoop.__init__,
               serve_loop.threshold_mask_sets):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn


def test_mesh_is_refused_until_sharded_serving_is_ported():
    """Sharded serving is ported (``tests/test_torch_sharded_serve.py``);
    a mesh larger than the process group is refused before any group
    comes up, never shrunk; a mesh of one rank serves as one process
    does."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib, serve, serve_loop
    _, _, _, _, tmodel, tparams = _build("stablelm_1p6b")
    store = serve_loop.threshold_mask_sets(tmodel, [1.0], device="cpu")
    classes = serve_loop.default_classes(store)
    if dist.is_initialized():
        pytest.fail("a process group is up in this test process")
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        serve.main(["--mesh", "2,1", "--device", "cpu"])
    assert not dist.is_initialized()
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(3)]

    def serve_all(mesh):
        loop = serve_loop.ServeLoop(tmodel, tparams, store, classes,
                                    mesh=mesh, device="cpu")
        reqs = [loop.submit(p, classes[0].name) for p in prompts]
        loop.shutdown(drain=True)
        return loop.stats()["decisions_sha256"], [r.tokens for r in reqs]
    try:
        one = mesh_lib.make_host_mesh(1, 1, device="cpu")
        assert serve_all(one) == serve_all(None)
    finally:
        mesh_lib.shutdown()


def test_serve_clis_and_example_run_on_the_cpu(capsys):
    """``launch.serve``, ``launch.serve_loop`` and the example, reduced,
    on the CPU."""
    import importlib.util
    from repro_torch.launch import serve, serve_loop
    assert serve.main(["--arch", "rwkv6_3b", "--reduced", "--batch", "2",
                       "--prompt-len", "20", "--gen", "3",
                       "--device", "cpu"]) == 0
    assert "generated" in capsys.readouterr().out
    assert serve_loop.main(["--reduced", "--requests", "4",
                            "--device", "cpu"]) == 0
    import json
    stats = json.loads(capsys.readouterr().out)
    assert stats["completed"] == 4 and stats["pending"] == 0
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_serve_lm.py")
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--gen", "4"]) == 0
    assert "generated" in capsys.readouterr().out
