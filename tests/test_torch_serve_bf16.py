"""Serving the LM families in their configs' own bfloat16: the port's caches,
prefill, decode step, slot copies and loop against the reference's on the
CPU.

One reduced config of each family — dense (StableLM-2-1.6B), RWKV-6 3B,
DeepSeek-MoE-16B and Zamba2-2.7B — with ``dtype="bfloat16"`` set by
``dataclasses.replace`` (``reduced()`` sets float32).  Parameters come
from the reference's ``init(PRNGKey(0))``, converted with
``convert.params_from_reference(dtype=None)`` so the bfloat16 leaves stay
bfloat16; masks (density 0.6) and tokens come from numpy seeds.  The MoE
runs at ``capacity_factor = E / top_k`` in both packages, so that no
(token, expert) pair is dropped at any length and the cached and uncached
paths compute one function (at the config's own 1.25 they differ by the
capacity rule, not by a fault).

Under test, with the tolerances stated before the first run:

* ``init_cache``: the tree's keys, nesting, shapes and dtypes equal the
  reference's — KV caches bfloat16, RWKV-6's ``state`` and Mamba2's
  ``ssm`` float32, RWKV-6's ``ptm`` / ``pcm`` and Mamba2's ``conv``
  bfloat16.
* ``make_prefill`` and ``make_decode_step`` (a prefill of 8 tokens, then 6
  decode steps teacher-forced on the same numpy tokens in both packages):
  the logits of each package, stacked over the prefill's last position
  and every step, are measured against the reference's float32 cached
  forward of the same parameters, upcast.  The port's largest error must
  be at most twice the reference's, plus 1e-3 (the yardstick of
  ``tests/test_torch_lm_bf16.py``); and the port's argmax must agree with
  the reference's bfloat16 argmax at >= 0.95 of the positions.  The
  port's greedy token from each step must be the argmax of its own logits
  (first index on ties, as ``jnp.argmax``).
* ``make_insert_slot``: from the same bits (a bfloat16 prefill cache
  copied into a decode cache filled with random bits), the port's result
  equals the reference's to the bit, leaf by leaf.
* ``chip_smoke.py``'s yardsticks of the bfloat16 serve phase, port-only:
  ``upcast_logits`` (one block upcast at a time) equals the float32
  forward of the upcast parameters to the bit, and a forward under
  ``pinned_routes`` given the routes it chooses itself equals the plain
  forward to the bit; ``route_gate`` passes a forward's own routes and
  refuses a served route whose expert is its token's least likely one.
* ``ServeLoop`` (reduced StableLM with buckets of 8, reduced RWKV-6 with
  exact-length prefill) under ``VirtualClock`` + ``default_chaos_plan(5)``
  + the ladder: the decision logs and their fingerprints, every request's
  state, its token count and its bill equal the reference's loop's.  The
  tokens themselves are greedy argmaxes of bfloat16 logits that the two
  frameworks round in other places (XLA rounds every bfloat16 operation,
  eager PyTorch rounds each of its own), so they are reported, not
  compared.
"""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_helpers import (random_masks, reference, to_jax_tree,
                                to_numpy_tree, tree_leaves)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["stablelm_1p6b", "rwkv6_3b", "deepseek_moe_16b", "zamba2_2p7b"]
B, P, STEPS, MAX_LEN = 2, 8, 6, 24
RATIO, ABS = 2.0, 1e-3
ARGMAX = 0.95
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models gain nothing from intra-op threads.  Put back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_cfg(cfg):
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def _build(arch):
    """(ref, bfloat16 reference model and params, float32 reference model
    and upcast params, port model, converted params), cached per
    process."""
    if arch in _CACHE:
        return _CACHE[arch]
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    jnp = ref.jnp
    rcfg = _bf16_cfg(ref.configs.get_config(arch).reduced())
    tcfg = _bf16_cfg(get_config(arch).reduced())
    rmodel, tmodel = ref.lm.LM(rcfg), LM(tcfg)
    rmodel32 = ref.lm.LM(dataclasses.replace(rcfg, dtype="float32"))
    rparams = rmodel.init(ref.jax.random.PRNGKey(0))
    rparams32 = ref.jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    tparams = convert.params_from_reference(to_numpy_tree(rparams), "cpu",
                                            dtype=None)
    _CACHE[arch] = ref, rmodel, rparams, rmodel32, rparams32, tmodel, tparams
    return _CACHE[arch]


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _pairs(tcache, rcache, path=""):
    """(path, port leaf, reference leaf) of two cache trees of one
    structure; fails where the structures differ."""
    if isinstance(rcache, dict):
        assert set(tcache) == set(rcache), path
        return [x for k in rcache
                for x in _pairs(tcache[k], rcache[k], f"{path}/{k}")]
    if isinstance(rcache, (list, tuple)):
        assert isinstance(tcache, (list, tuple)), path
        assert len(tcache) == len(rcache), path
        return [x for i, (a, b) in enumerate(zip(tcache, rcache))
                for x in _pairs(a, b, f"{path}/{i}")]
    return [(path, tcache, rcache)]


def _bits(a) -> np.ndarray:
    """The raw 16- or 32-bit patterns of a port tensor or a jax array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int32)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_cache_tree_equals_the_reference(arch):
    ref, rmodel, _, _, _, tmodel, _ = _build(arch)
    rc = rmodel.init_cache(3, 10)
    tc = tmodel.init_cache(3, 10, "cpu")
    pairs = _pairs(tc, rc)
    kinds = set()
    for path, t, r in pairs:
        assert tuple(t.shape) == tuple(r.shape), path
        assert _dtype_name(t) == str(r.dtype), (path, t.dtype, r.dtype)
        assert not bool(t.float().abs().max()), path
        kinds.add((path.rsplit("/", 1)[-1] if "kv" not in path else "kv",
                   _dtype_name(t)))
    leaves = tree_leaves(tc)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    want = {"stablelm_1p6b": {("kv", "bfloat16")},
            "rwkv6_3b": {("state", "float32"), ("ptm", "bfloat16"),
                         ("pcm", "bfloat16")},
            "deepseek_moe_16b": {("kv", "bfloat16")},
            "zamba2_2p7b": {("ssm", "float32"), ("conv", "bfloat16"),
                            ("kv", "bfloat16")}}[arch]
    assert kinds == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_prefill_and_decode_match_the_reference(arch):
    """A prefill of P tokens and STEPS decode steps on the same tokens in
    both packages (teacher-forced), each package's logits against the
    reference's float32 cached forward of the upcast parameters."""
    from repro_torch.core import masks as M
    from repro_torch.training import serve
    ref, rmodel, rparams, rmodel32, rparams32, tmodel, tparams = \
        _build(arch)
    jnp = ref.jnp
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(B, P + STEPS)).astype(np.int32)
    tree = random_masks(tmodel.mask_sites(), 6)
    rm = ref.masks.as_device(tree)
    tm = M.as_device(tree, "cpu")

    def reference_logits(model, params):
        fwd = ref.jax.jit(lambda p, m, t, c, cl: model.forward(
            p, m, t, cache=c, cache_len=cl))
        last, cache = ref.serve.make_prefill(model)(
            params, rm, jnp.asarray(toks[:, :P]),
            model.init_cache(B, MAX_LEN))
        out = [np.asarray(last.astype(jnp.float32))]
        for t in range(STEPS):
            logits, cache = fwd(params, rm,
                                jnp.asarray(toks[:, P + t:P + t + 1]),
                                cache, P + t)
            out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        return np.stack(out)
    want = reference_logits(rmodel, rparams)
    exact = reference_logits(rmodel32, rparams32)
    ref_err = float(np.abs(want - exact).max())
    assert ref_err > 0

    prefill, step = serve.make_prefill(tmodel), serve.make_decode_step(tmodel)
    with torch.no_grad():
        cache = tmodel.init_cache(B, MAX_LEN, "cpu")
        last, cache = prefill(tparams, tm, torch.from_numpy(toks[:, :P]),
                              cache)
        assert last.dtype == torch.bfloat16
        got = [last.float().numpy()]
        for t in range(STEPS):
            nxt, cache, logits = step(
                tparams, tm, torch.from_numpy(toks[:, P + t:P + t + 1]),
                cache, P + t)
            assert logits.dtype == torch.bfloat16
            assert torch.equal(nxt[:, 0], logits.argmax(-1).to(torch.int32))
            got.append(logits.float().numpy())
    got = np.stack(got)
    assert got.shape == (1 + STEPS, B, cfg.vocab) and np.isfinite(got).all()
    err = float(np.abs(got - exact).max())
    assert err <= RATIO * ref_err + ABS, (arch, err, ref_err)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agree >= ARGMAX, (arch, agree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_insert_slot_equals_the_reference_bits(arch):
    """The port's prefill cache of one request, copied into slot 1 of a
    B=3 decode cache of random bits, by each package's
    ``make_insert_slot`` from the same bits: equal bits, leaf by leaf."""
    from repro_torch.core import masks as M
    from repro_torch.training import serve
    ref, rmodel, _, _, _, tmodel, tparams = _build(arch)
    cfg = tmodel.cfg
    tree = random_masks(tmodel.mask_sites(), 8)
    p = np.random.default_rng(9).integers(0, cfg.vocab, (1, P)).astype(
        np.int32)
    with torch.no_grad():
        _, small = tmodel.forward(tparams, M.as_device(tree, "cpu"),
                                  torch.from_numpy(p),
                                  cache=tmodel.init_cache(1, MAX_LEN, "cpu"))
    gen = torch.Generator().manual_seed(10)
    big = tmodel.init_cache(3, MAX_LEN, "cpu")
    for t in tree_leaves(big):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    rbig, rsmall = to_jax_tree(ref, big), to_jax_tree(ref, small)
    rout = ref.serve.make_insert_slot(rmodel)(rbig, rsmall, ref.jnp.asarray(1))
    tout = serve.make_insert_slot(tmodel)(big, small, 1)
    pairs = _pairs(tout, rout)
    assert any(t.dtype == torch.bfloat16 for _, t, _ in pairs)
    for path, t, r in pairs:
        assert _dtype_name(t) == str(r.dtype), path
        np.testing.assert_array_equal(_bits(t), _bits(r), err_msg=path)


def _bf16_parity_loops(arch, bucket, classes_of, submit, **kw):
    """The reference's loop and the port's over the same converted bfloat16
    parameters and synthetic budgets; ``submit(loop)`` feeds both."""
    from repro_torch.launch import faults, serve_loop
    ref, rmodel, rparams, _, _, tmodel, tparams = _build(arch)
    out = []
    for sl, fl, model, params, dev in (
            (ref.serve_loop, ref.faults, rmodel, rparams, {}),
            (serve_loop, faults, tmodel, tparams, {"device": "cpu"})):
        store = sl.threshold_mask_sets(model, [1.0, 0.25], seed=0, **dev)
        loop = sl.ServeLoop(
            model, params, store, classes_of(sl, store), prompt_bucket=bucket,
            ladder=sl.DegradationLadder.from_store(store),
            clock=fl.VirtualClock(), fault_plan=fl.default_chaos_plan(5),
            **kw, **dev)
        reqs = submit(loop)
        loop.shutdown(drain=True)
        out.append((loop, reqs))
    return out


def _loop_case(arch):
    if arch == "stablelm_1p6b":
        def classes(sl, store):
            return [sl.SLOClass("premium", store.names[0], 4,
                                deadline_ms=900.0, priority=1),
                    sl.SLOClass("economy", store.names[1], 4,
                                deadline_ms=2500.0)]

        def submit(loop):
            rng = np.random.default_rng(9)
            reqs = []
            for i in range(12):
                reqs.append(loop.submit(
                    rng.integers(0, 128, int(rng.integers(2, 20))),
                    ("premium", "economy")[i % 2]))
                if i % 3 == 2:
                    loop.step()
            return reqs
        return 8, classes, submit, dict(slots=2, max_len=32, queue_cap=4)

    def classes(sl, store):
        return [sl.SLOClass("premium", store.names[0], 3),
                sl.SLOClass("economy", store.names[1], 3)]

    def submit(loop):
        rng = np.random.default_rng(4)
        return [loop.submit(rng.integers(0, 128, int(rng.integers(3, 21))),
                            ("premium", "economy")[i % 2])
                for i in range(6)]
    return None, classes, submit, dict(slots=2, max_len=32)


@pytest.mark.parametrize("arch", ["stablelm_1p6b", "rwkv6_3b"])
def test_bfloat16_serve_loop_decides_and_bills_as_the_reference(arch):
    from repro_torch.launch import serve_loop
    bucket, classes, submit, kw = _loop_case(arch)
    (rloop, rreqs), (tloop, treqs) = _bf16_parity_loops(
        arch, bucket, classes, submit, **kw)
    assert tloop.model.dtype == torch.bfloat16
    assert tloop.decision_log == rloop.decision_log
    assert serve_loop.decisions_fingerprint(tloop.decision_log) == \
        reference().serve_loop.decisions_fingerprint(rloop.decision_log)
    assert [r.state for r in treqs] == [r.state for r in rreqs]
    assert [len(r.tokens) for r in treqs] == [len(r.tokens) for r in rreqs]
    assert [r.bill for r in treqs] == [r.bill for r in rreqs]
    assert tloop.fault_stats == rloop.fault_stats
    assert any(r.tokens for r in treqs)


def _chip_smoke():
    """``chip_smoke.py`` as a module (registered, as its dataclasses
    need)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_upcast_logits_is_the_float32_forward(arch):
    from repro_torch.core import masks as M
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib
    cs = _chip_smoke()
    _, _, _, _, _, tmodel, tparams = _build(arch)
    m32 = LM(dataclasses.replace(tmodel.cfg, dtype="float32"))
    p32 = opt_lib.tree_map(lambda t: t.float(), tparams)
    tm = M.as_device(random_masks(tmodel.mask_sites(), 11), "cpu")
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, tmodel.cfg.vocab, (B, 16)))
    with torch.no_grad():
        got = cs.upcast_logits(tmodel, tparams, tm, toks)
        want = m32.forward(p32, tm, toks)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_pinned_own_routes_leave_the_forward_unchanged():
    from repro_torch.core import masks as M
    cs = _chip_smoke()
    _, _, _, _, _, tmodel, tparams = _build("deepseek_moe_16b")
    tm = M.as_device(random_masks(tmodel.mask_sites(), 13), "cpu")
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, tmodel.cfg.vocab, (B, 16)))
    with torch.no_grad(), cs.record_routes() as rec:
        want = tmodel.forward(tparams, tm, toks)
    routes = [r[0] for r in rec.calls]
    assert routes
    with torch.no_grad(), cs.pinned_routes(routes) as pin:
        got = tmodel.forward(tparams, tm, toks)
    assert pin.calls == len(routes)
    assert torch.equal(got, want)


def test_route_gate_refuses_a_wrong_expert():
    from repro_torch.core import masks as M
    cs = _chip_smoke()
    _, _, _, _, _, tmodel, tparams = _build("deepseek_moe_16b")
    tm = M.as_device(random_masks(tmodel.mask_sites(), 15), "cpu")
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, tmodel.cfg.vocab, (B, 16)))
    with torch.no_grad(), cs.record_routes() as rec:
        tmodel.forward(tparams, tm, toks)
    served = [r[0] for r in rec.calls]

    def gate(routes):
        pin_bf, pin_32 = cs.pinned_routes(routes), cs.pinned_routes(routes)
        with torch.no_grad(), pin_bf:
            tmodel.forward(tparams, tm, toks)
        with pin_32:
            cs.upcast_logits(tmodel, tparams, tm, toks)
        return cs.route_gate(routes, pin_bf, pin_32, "test")
    out = gate(served)
    assert out["experts_not_own"] == 0 and out["moe_layers"] == len(served)
    # token 3 of row 0 in the last MoE layer served by its least likely
    # expert in place of its k-th choice
    wrong = [r.clone() for r in served]
    with torch.no_grad(), cs.pinned_routes(served) as pin:
        tmodel.forward(tparams, tm, toks)
    wrong[-1][0, 3, -1] = pin.logits[-1][0, 3].argmin()
    with pytest.raises(SystemExit):
        gate(wrong)
