"""The port's RWKV-6 path against the JAX package's, on the CPU.

The scan's plain version (``kernels.ref.rwkv6_scan_ref``, what CPU tensors
and ``ops.rwkv6`` use, and what ``chip_smoke.py`` holds the CUDA kernel to
on the card) is held against the reference's Pallas kernel in interpret
mode and its token-serial oracle; the RWKV blocks and the LM against the
reference's on the reduced ``rwkv6_3b`` config (d_model 64, 4 heads of 16,
d_ff 96, 2 repeats), with parameters converted from the reference's init
and inputs made with numpy from a seed.

Tolerances: 3e-4 for the scan (the reference's own, ``test_kernels.py``:
the chunked form divides by in-chunk decay products), 1e-5 for one block,
1e-4 on logits (the LM tests' tolerance).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import random_masks, reference, to_numpy_tree
from test_torch_lm import (_assert_margins, _build, _dev, _greedy_batch,
                           _logs, _tokens)

ARCH = "rwkv6_3b"
SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
BLOCK_TOL = dict(rtol=0.0, atol=1e-5)
LOGIT_TOL = dict(rtol=0.0, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_inputs(seed, bh, T, K, V):
    """The reference test's distribution (``test_kernels.py:233``)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.normal(size=(bh, T, K)).astype(f) * 0.5
    k = rng.normal(size=(bh, T, K)).astype(f) * 0.5
    v = rng.normal(size=(bh, T, V)).astype(f)
    w = rng.uniform(0.7, 0.999, size=(bh, T, K)).astype(f)
    u = rng.normal(size=(bh, K)).astype(f) * 0.3
    s0 = rng.normal(size=(bh, K, V)).astype(f) * 0.1
    return r, k, v, w, u, s0


# ------------------------------------------------------------------ kernel


@pytest.mark.parametrize("T,K,V,chunk", [(32, 8, 8, 8), (64, 16, 32, 16),
                                         (64, 8, 16, 32)])
def test_scan_plain_version_matches_pallas_interpret_and_oracle(T, K, V,
                                                                chunk):
    from repro_torch.kernels import ops, ref as T_ref
    ref = reference()
    args = _scan_inputs(3, 4, T, K, V)
    j = [ref.jnp.asarray(a) for a in args]
    y_pl, s_pl = ref.rwkv6_scan.rwkv6_scan(*j, chunk=chunk, interpret=True)
    y_or, s_or = ref.ops._rwkv6_scan_jnp(*j)
    y, s = ops.rwkv6(*map(_t, args), chunk=chunk)
    assert y.shape == (4, T, V) and s.shape == (4, K, V)
    assert y.dtype == s.dtype == torch.float32
    for want_y, want_s in ((y_pl, s_pl), (y_or, s_or)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SCAN_TOL)
    # the serial plain version (chip_smoke.py's float64 yardstick) is the
    # reference's token loop
    y1, s1 = ref.ref.rwkv6_chunk_ref(*(a[0] for a in j))
    y2, s2 = T_ref.rwkv6_serial_ref(*map(_t, args))
    np.testing.assert_allclose(y2[0].numpy(), np.asarray(y1), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(s2[0].numpy(), np.asarray(s1), rtol=2e-5,
                               atol=2e-5)


def test_scan_takes_a_per_head_u_table_and_stride0_rows():
    """u as an (H, K) table over B·H rows, u and the state as stride-0
    expands: the same numbers as the full (BH, K) / (BH, K, V) operands."""
    from repro_torch.kernels import ops
    r, k, v, w, _, _ = map(_t, _scan_inputs(5, 6, 32, 8, 8))
    table = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    s0 = torch.zeros(1, 8, 8).expand(6, 8, 8)
    want = ops.rwkv6(r, k, v, w, table.repeat(2, 1), s0.contiguous())
    for got in (ops.rwkv6(r, k, v, w, table, s0),
                ops.rwkv6(r, k, v, w, table.repeat(2, 1), s0)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    one = ops.rwkv6(r, k, v, w, table[:1].expand(6, 8), s0)
    np.testing.assert_array_equal(
        one[0].numpy(), ops.rwkv6(r, k, v, w, table[:1].repeat(6, 1),
                                  s0)[0].numpy())
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6(r, k, v, w, table[:2].repeat(2, 1)[:4], s0)


def test_scan_refuses_a_ragged_sequence_and_cpu_tensors_in_the_wrapper():
    """ops.rwkv6 on CPU tensors takes the plain version and counts no
    launch; the CUDA wrapper refuses CPU tensors; T % chunk != 0 raises as
    the reference asserts."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    args = list(map(_t, _scan_inputs(6, 2, 40, 8, 8)))
    before = dict(build.launch_counts)
    assert "rwkv6_scan" in before
    ops.rwkv6(*args, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rwkv6_scan(*args, chunk=8)
    assert build.launch_counts == before
    with pytest.raises(ValueError, match="multiple"):
        ops.rwkv6(*args, chunk=32)


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("decay_first", [False, True])
def test_linattn_chunked_matches_reference(decay_first):
    from repro_torch.models import ssm
    ref = reference()
    rng = np.random.default_rng(7)
    f = np.float32
    B, H, T, K, V = 2, 3, 48, 8, 16
    r = rng.normal(size=(B, H, T, K)).astype(f) * 0.5
    k = rng.normal(size=(B, H, T, K)).astype(f) * 0.5
    v = rng.normal(size=(B, H, T, V)).astype(f)
    w = rng.uniform(0.8, 0.999, size=(B, H, T, K)).astype(f)
    u = rng.normal(size=(H, K)).astype(f) * 0.3
    s0 = rng.normal(size=(B, H, K, V)).astype(f) * 0.1
    j = ref.jnp.asarray
    want = ref.ssm.linattn_chunked(j(r), j(k), j(v), j(w), j(u), j(s0),
                                   chunk=16, decay_first=decay_first)
    got = ssm.linattn_chunked(_t(r), _t(k), _t(v), _t(w), _t(u), _t(s0),
                              chunk=16, decay_first=decay_first)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BLOCK_TOL)


def test_time_and_channel_mix_match_reference():
    """One block's time-mix and masked channel-mix on converted params
    (repeat 1 of the stack), a (2, 17, 64) input, random binary mask."""
    from repro_torch.models import lm, ssm
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    rssm = ref.ssm
    tp = lm._index(tparams["stack"]["0"], 1)["tmix"]
    rp = ref.jax.tree.map(lambda a: a[1], rparams["stack"]["0"]["tmix"])
    rc = lm._rwkv_cfg(tmodel.cfg)
    rrc = rssm.RWKVCfg(d_model=64, d_ff=96, head_dim=16)
    x = np.random.default_rng(8).normal(size=(2, 17, 64)).astype(np.float32)
    want, _ = rssm.rwkv_time_mix(rp, rrc, ref.jnp.asarray(x))
    np.testing.assert_allclose(ssm.rwkv_time_mix(tp, rc, _t(x)).numpy(),
                               np.asarray(want), **BLOCK_TOL)
    site = tmodel.mask_sites()["s0.rwkv"]
    site1 = dataclasses.replace(site, shape=site.shape[1:])
    mask = (np.random.default_rng(9).random(96) < 0.5).astype(np.float32)
    want, _ = rssm.rwkv_channel_mix(
        rp, rrc, ref.jnp.asarray(x), ref.jnp.asarray(mask),
        ref.linearize.MaskSite((96,), "sqrelu"))
    got = ssm.rwkv_channel_mix(tp, rc, _t(x), _t(mask), site1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


# ---------------------------------------------------------------------- LM


@pytest.mark.parametrize("S", [17, 64])
def test_logits_match_reference_over_one_and_two_chunks(S):
    """S = 17 is one scan chunk; S = 64 two, so the state carried from
    chunk to chunk is exercised."""
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    toks = _tokens(tmodel.cfg, 20 + S, batch=2, seq=S)
    tree = random_masks(tmodel.mask_sites(), 21)
    want, _ = rmodel.forward(rparams, ref.masks.as_device(tree),
                             ref.jnp.asarray(toks))
    got = tmodel.forward(tparams, _dev(tree), _t(toks))
    assert got.shape == (2, S, tmodel.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_stacked_forward_equals_per_candidate_forwards():
    """Stacked (N, B, S, D) activations: the shared embedding reaches the
    first time-mix un-stacked and the first stacked gate as a stride-0
    view; candidate i of the stack is the forward of tree i, from the
    tokens and from the cached embedding, and the reference's vmap."""
    from repro_torch.core import masks as M
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    toks = _tokens(tmodel.cfg, 30, batch=2, seq=64)
    x = _t(toks)
    trees = [random_masks(tmodel.mask_sites(), 31 + i) for i in range(3)]
    stacked = _dev(M.stack_trees(trees))
    got = tmodel.forward(tparams, stacked, x)
    pre = tmodel.forward_pre(tparams, x)
    got_pre = tmodel.forward(tparams, stacked, None, pre=pre)
    assert got.shape == (3, 2, 64, tmodel.cfg.vocab)
    np.testing.assert_array_equal(got_pre.numpy(), got.numpy())
    for i, tree in enumerate(trees):
        one = tmodel.forward(tparams, _dev(tree), x)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=0,
                                   atol=1e-5)
    j = ref.jnp.asarray
    want = ref.jax.vmap(lambda m: rmodel.forward(rparams, m, j(toks))[0])(
        ref.masks.as_device(M.stack_trees(trees)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    """The reference's linattn_chunked needs S % min(32, S) == 0: 40 and
    127 tokens cannot run there, and the port says so."""
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    tree = _dev(random_masks(tmodel.mask_sites(), 40))
    for S in (40, 127):
        with pytest.raises(ValueError, match="not a multiple of the scan "
                                             "chunk 32"):
            tmodel.forward(tparams, tree, torch.zeros(1, S,
                                                      dtype=torch.long))


def test_split_forwards_at_the_mid_scan_cut():
    """``test_split_forward.py:149`` for the port: a pure scanned stack,
    every cut a carry checkpoint, prefix ∘ suffix == forward exactly at
    ``s0.rwkv@0`` and ``s0.rwkv@1``, prefix_ext along the repeats, the
    prefixes against the reference's."""
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    assert tmodel.site_order() == ("s0.rwkv@0", "s0.rwkv@1")
    assert tmodel.site_repeats() == {"s0.rwkv": 2}
    toks = _tokens(tmodel.cfg, 41, batch=2, seq=17)
    x = _t(toks)
    tree = random_masks(tmodel.mask_sites(), 42)
    md = _dev(tree)
    full = tmodel.forward(tparams, md, x)
    cached = {}
    for site in tmodel.site_order():
        cached[site] = tmodel.forward_prefix(tparams, md, x, site)
        want = rmodel.forward_prefix(rparams, ref.masks.as_device(tree),
                                     ref.jnp.asarray(toks), site)
        np.testing.assert_allclose(cached[site].numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        out = tmodel.forward_suffix(tparams, md, cached[site], site)
        np.testing.assert_array_equal(out.numpy(), full.numpy())
    ext = tmodel.forward_prefix(tparams, md, x, "s0.rwkv@1",
                                from_site="s0.rwkv@0",
                                cached=cached["s0.rwkv@0"])
    np.testing.assert_array_equal(ext.numpy(), cached["s0.rwkv@1"].numpy())


def test_run_bcd_selects_the_references_blocks():
    """Reduced RWKV-6 (2 repeats, 192 nonlinearities), greedy labels: the
    port's four engines select the reference's blocks with the same step
    logs as the reference's sequential and batched engines."""
    from repro_torch.core import bcd as B, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    batch, _ = _greedy_batch(tmodel, tparams, seed=43)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    total = M.count(masks0)
    kw = dict(b_target=total - 3 * 16, drc=16, rt=8, adt=-100.0,
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


def test_sited_suffix_matches_batched_at_the_second_repeat():
    """Site-local candidates at ``s0.rwkv@1``: the suffix engine (the
    ``fused`` flag leaves rwkv blocks on the gate route) equals the
    reference's batched engine and computes the prefix once."""
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    ref, rmodel, rparams, tmodel, tparams = _build(ARCH)
    batch, _ = _greedy_batch(tmodel, tparams, seed=44)
    masks0 = linearize.init_masks(tmodel.mask_sites())
    idx = M.sample_removal_indices_within(
        np.random.default_rng(0), masks0, 12, 6, ["s0.rwkv@1"],
        repeat_sites=tmodel.site_repeats())
    assert np.all(idx // 96 == 1)
    stacked = M.materialize_candidates(masks0, idx)
    want = ref.engine.make_evaluator(
        "batched", eval_fn=rmodel.make_eval_fn(rparams, batch), pad_to=4
    ).evaluate(stacked)
    for fused in (False, True):
        ev, _, _ = make_bcd_evaluator("suffix", tmodel, batch,
                                      {"params": tparams}, chunk_size=4,
                                      rt=6, fused_kernels=fused,
                                      device="cpu")
        ev.begin_step(masks0)
        for _ in range(2):
            got = ev.evaluate(E.SitedChunk("s0.rwkv@1", stacked))
            np.testing.assert_array_equal(got, want)
        assert (ev.trie.misses, ev.trie.hits) == (1, 1)


def test_params_from_reference_carries_the_rwkv_tree():
    """At the config's own bfloat16, ``dtype=None`` keeps bfloat16
    projections beside the float32 lerp weights, decay bias and bonus, and
    the nested per-head norm; the port's own init makes the same tree."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    ref = reference()
    rcfg = dataclasses.replace(ref.configs.get_config(ARCH).reduced(),
                               dtype="bfloat16")
    tree = to_numpy_tree(ref.lm.LM(rcfg).init(ref.jax.random.PRNGKey(0)))
    kept = convert.params_from_reference(tree, "cpu", dtype=None)
    tm = kept["stack"]["0"]["tmix"]
    assert tm["w_r"].dtype == tm["w_cv"].dtype == torch.bfloat16
    for key in ("mu", "mu_c", "w_bias", "u"):
        assert tm[key].dtype == torch.float32, key
    assert tm["ln_x"]["scale"].shape == (2, 16)
    assert tm["u"].shape == (2, 4, 16)
    np.testing.assert_array_equal(
        tm["w_k"].float().numpy(),
        np.asarray(tree["stack"]["0"]["tmix"]["w_k"], dtype=np.float32))
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    own = LM(tcfg).init(torch.Generator().manual_seed(0), "cpu")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if isinstance(t, list):
            return [layout(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert layout(own) == layout(kept)


def test_full_size_rwkv6_sites():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    m = LM(get_config(ARCH))
    sites = m.mask_sites()
    assert list(sites) == ["s0.rwkv"]
    assert sites["s0.rwkv"].shape == (32, 8960)
    assert sites["s0.rwkv"].kind == "sqrelu"
    assert m.relu_count() == 32 * 8960 == 286720
    assert m.site_order()[0] == "s0.rwkv@0" and len(m.site_order()) == 32
