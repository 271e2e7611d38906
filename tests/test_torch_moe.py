"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Routing logits, activations and masks are made with numpy from a seed;
parameters come from the reference's ``moe_init`` and are converted with
``repro_torch.convert.params_from_reference``.  Under test:

- ``_capacity``, the decode step's exact capacity included;
- the routing bookkeeping of ``_route`` and ``_dispatch_row`` — chosen
  experts, slots, each slot's source token, kept pairs and the dispatched
  slot rows — bit-equal to the reference's, row by row, on random logits,
  on logits whose routes overflow an expert's capacity, and on logits with
  tied router probabilities (``lax.top_k`` keeps the lower index, and so
  must the port).  The gates are held at 1e-6 relative: they are softmax
  values, and XLA's float32 softmax sums the exponentials in another order
  than PyTorch's (a last-bit difference in most entries);
- ``moe_ffn`` under both dispatch modes, with and without a shared expert,
  within 1e-5 of the reference;
- stacked against one-at-a-time candidates, bit for bit, under overflow:
  the port's counterpart of the reference's
  ``test_moe_routing_stacked_vs_sequential_bitwise_under_overflow``.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference, to_numpy_tree


def _cfgs(dispatch="scatter", shared=False, capacity_factor=1.25):
    from repro_torch.models import moe
    ref = reference()
    kw = dict(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
              n_shared=1 if shared else 0, d_ff_shared=12 if shared else 0,
              capacity_factor=capacity_factor, dispatch=dispatch)
    return ref, ref.moe.MoECfg(**kw), moe.MoECfg(**kw)


def _params(ref, rc, skew=0.0):
    from repro_torch import convert
    rp = ref.moe.moe_init(ref.jax.random.PRNGKey(0), rc,
                          dtype=ref.jnp.float32)
    if skew:
        # expert 0 oversubscribed: routes overflow its capacity
        rp["router"] = rp["router"].at[:, 0].add(skew)
    return rp, convert.params_from_reference(to_numpy_tree(rp), "cpu")


@pytest.mark.parametrize("seq", [1, 2, 7, 16, 64, 127, 1000])
def test_capacity_equals_reference(seq):
    from repro_torch.configs import get_config
    from repro_torch.models import lm as tlm, moe
    ref = reference()
    for arch in ("deepseek_moe_16b", "mixtral_8x22b"):
        for cfg in (get_config(arch), get_config(arch).reduced()):
            rc = ref.lm._moe_cfg(ref.configs.get_config(arch)) \
                if cfg.d_model > 64 else \
                ref.lm._moe_cfg(ref.configs.get_config(arch).reduced())
            assert moe._capacity(tlm._moe_cfg(cfg), seq) == \
                ref.moe._capacity(rc, seq)
    _, rc, tc = _cfgs()
    assert moe._capacity(tc, seq) == ref.moe._capacity(rc, seq)
    if seq == 1:
        assert moe._capacity(tc, 1) == 1


def _logits(case, S, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, S, E)).astype(np.float32)
    if case == "overflow":
        x[..., 1] += 3.0                 # expert 1 is everyone's first
    elif case == "ties":
        x = np.round(x) / 2              # a coarse grid: many exact ties
    return x


@pytest.mark.parametrize("case", ["random0", "random1", "overflow", "ties"])
def test_route_and_dispatch_bookkeeping_bit_equal(case):
    """Row by row: ``_route`` (gates, slot_src, slot_tk) and
    ``_dispatch_row`` (slot rows, gates, slot_tk, keep_tk) of the port on
    (3, S, E) logits against the reference's on each row; the port routes
    all three rows in one call."""
    from repro_torch.models import moe
    ref = reference()
    kw = dict(d_model=6, n_experts=8, top_k=3, d_ff_expert=4,
              capacity_factor=1.0)
    rc, tc = ref.moe.MoECfg(**kw), moe.MoECfg(**kw)
    S = 24
    C = moe._capacity(tc, S)
    logits = _logits(case.rstrip("01"), S, 8, seed=int(case[-1])
                     if case[-1].isdigit() else 5)
    x = np.random.default_rng(9).normal(size=(3, S, 6)).astype(np.float32)
    tg, tsrc, ttk = moe._route(torch.from_numpy(logits), tc, C)
    txg, (tg2, ttk2, tkeep) = moe._dispatch_row(
        torch.from_numpy(x), torch.from_numpy(logits), tc, C)
    dropped = 0
    for b in range(3):
        rg, rsrc, rtk = ref.moe._route(ref.jnp.asarray(logits[b]), rc, C)
        np.testing.assert_array_equal(ttk[b].numpy(), np.asarray(rtk))
        # the last entry is the overflow slot, which the reference writes
        # with a duplicate-index scatter and never reads
        np.testing.assert_array_equal(tsrc[b, :-1].numpy(),
                                      np.asarray(rsrc)[:-1])
        np.testing.assert_allclose(tg[b].numpy(), np.asarray(rg),
                                   rtol=1e-6, atol=0)
        rxg, (rg2, rtk2, rkeep) = ref.moe._dispatch_row(
            ref.jnp.asarray(x[b]), ref.jnp.asarray(logits[b]), rc, C)
        np.testing.assert_array_equal(txg[b].numpy(), np.asarray(rxg))
        np.testing.assert_array_equal(ttk2[b].numpy(), np.asarray(rtk2))
        np.testing.assert_array_equal(tkeep[b].numpy(), np.asarray(rkeep))
        np.testing.assert_array_equal(tg2[b].numpy(), tg[b].numpy())
        dropped += int((~tkeep[b]).sum())
    assert torch.equal(ttk, ttk2)
    assert torch.equal(tkeep, ttk < tc.n_experts * C)
    if case == "overflow":
        assert dropped > 0, "the case no longer overflows"
    if case == "ties":
        probs = torch.softmax(torch.from_numpy(logits), -1)
        top = probs.sort(-1, descending=True).values
        assert bool((top[..., 2] == top[..., 3]).any()), \
            "no tie at the top-k boundary"


def test_ties_go_to_the_lower_expert_index():
    from repro_torch.models import moe
    c = moe.MoECfg(d_model=4, n_experts=6, top_k=2, d_ff_expert=4)
    logits = torch.tensor([[[0.0, 1.0, 1.0, 1.0, 0.0, 1.0]]])
    gates, eidx = moe._top_k(logits, c)
    assert eidx.tolist() == [[[1, 2]]]
    assert gates.tolist() == [[[0.5, 0.5]]]


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_matches_reference(dispatch, shared):
    from repro_torch.core import linearize as TL
    from repro_torch.models import moe
    ref, rc, tc = _cfgs(dispatch, shared, capacity_factor=0.75)
    rp, tp = _params(ref, rc, skew=1.0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    mask = (rng.random((4, 8)) < 0.6).astype(np.float32)
    smask = (rng.random((12,)) < 0.6).astype(np.float32)
    rsite = ref.linearize.MaskSite((4, 8), "silu")
    tsite = TL.MaskSite((4, 8), "silu")
    rss = ref.linearize.MaskSite((12,), "silu") if shared else None
    tss = TL.MaskSite((12,), "silu") if shared else None
    j = ref.jnp.asarray
    want = ref.moe.moe_ffn(rp, rc, j(x), j(mask), rsite,
                           shared_mask=j(smask) if shared else None,
                           shared_site=rss)
    got = moe.moe_ffn(tp, tc, torch.from_numpy(x), torch.from_numpy(mask),
                      tsite, torch.from_numpy(smask) if shared else None,
                      tss)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # the two dispatch modes fill the same slots: the same bits
    other = moe.MoECfg(**{**tc.__dict__, "dispatch": "gather"
                          if dispatch == "scatter" else "scatter"})
    again = moe.moe_ffn(tp, other, torch.from_numpy(x),
                        torch.from_numpy(mask), tsite,
                        torch.from_numpy(smask) if shared else None, tss)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_stacked_vs_sequential_bitwise_under_overflow(dispatch):
    """Six stacked candidates, with the activation shared by them and with
    one activation each, against six one-at-a-time calls: the same bits,
    while routes overflow."""
    from repro_torch.core import linearize as TL
    from repro_torch.models import moe
    ref, rc, tc = _cfgs(dispatch, shared=True, capacity_factor=0.5)
    rp, tp = _params(ref, rc, skew=3.0)
    B, S = 2, 64
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, S, 16)).astype(np.float32))
    site = TL.MaskSite((4, 8), "relu")
    ssite = TL.MaskSite((12,), "relu")
    rng = np.random.default_rng(0)
    stacked = torch.from_numpy((rng.random((6, 4, 8)) > 0.3)
                               .astype(np.float32))
    sstacked = torch.from_numpy((rng.random((6, 12)) > 0.3)
                                .astype(np.float32))
    batched = moe.moe_ffn(tp, tc, x, stacked, site, sstacked, ssite)
    seq = torch.stack([moe.moe_ffn(tp, tc, x, stacked[i], site,
                                   sstacked[i], ssite) for i in range(6)])
    assert batched.shape == (6, B, S, 16)
    assert torch.equal(batched, seq)
    # one activation per candidate (the stack after a first stacked gate)
    xs = x + 0.1 * torch.arange(6, dtype=torch.float32)[:, None, None, None]
    batched = moe.moe_ffn(tp, tc, xs, stacked, site, sstacked, ssite)
    seq = torch.stack([moe.moe_ffn(tp, tc, xs[i], stacked[i], site,
                                   sstacked[i], ssite) for i in range(6)])
    assert torch.equal(batched, seq)
    # the routing did drop pairs
    logits = x.float() @ tp["router"]
    _, _, slot_tk = moe._route(logits, tc, moe._capacity(tc, S))
    assert bool((slot_tk == tc.n_experts * moe._capacity(tc, S)).any()), \
        "the setup no longer overflows capacity"


def test_decode_step_routes_every_pair():
    """One token: capacity 1, every (token, k) pair keeps its slot, and the
    output equals the reference's."""
    from repro_torch.core import linearize as TL
    from repro_torch.models import moe
    ref, rc, tc = _cfgs(shared=True)
    rp, tp = _params(ref, rc)
    x = np.random.default_rng(2).normal(size=(3, 1, 16)).astype(np.float32)
    mask = np.ones((4, 8), np.float32)
    smask = np.ones((12,), np.float32)
    logits = torch.from_numpy(x) @ tp["router"]
    _, _, slot_tk = moe._route(logits, tc, 1)
    assert bool((slot_tk < tc.n_experts).all())
    j = ref.jnp.asarray
    want = ref.moe.moe_ffn(rp, rc, j(x), j(mask),
                           ref.linearize.MaskSite((4, 8), "silu"),
                           shared_mask=j(smask),
                           shared_site=ref.linearize.MaskSite((12,), "silu"))
    got = moe.moe_ffn(tp, tc, torch.from_numpy(x), torch.from_numpy(mask),
                      TL.MaskSite((4, 8), "silu"), torch.from_numpy(smask),
                      TL.MaskSite((12,), "silu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_init_keeps_the_reference_tree():
    from repro_torch.core import linearize as TL
    from repro_torch.models import moe
    ref, rc, tc = _cfgs(shared=True)
    rp = to_numpy_tree(ref.moe.moe_init(ref.jax.random.PRNGKey(0), rc))
    tp = moe.moe_init(torch.Generator().manual_seed(0), tc, device="cpu")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        return tuple(t.shape), str(t.dtype).replace("torch.", "")
    assert layout(tp) == layout(rp)
    bad = moe.MoECfg(**{**tc.__dict__, "dispatch": "nope"})
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(tp, bad, torch.zeros(1, 4, 16), torch.ones(4, 8),
                    TL.MaskSite((4, 8)))
