"""The port's kernel modules against the JAX package's kernels, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function — the Pallas
kernel in interpret mode, as the JAX package's own tests run it — and through
the port's entry point in ``repro_torch.kernels.ops``, which on a CPU tensor
takes the plain PyTorch version (the version the CUDA kernels are held
against on the card by ``chip_smoke.py``).

Tolerances are the reference's own: 1e-6 for the gate, 1e-5 for the fused
gate→conv (its sums run in another order).
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

KINDS = ["relu", "gelu", "silu", "sqrelu"]
GATE_TOL = dict(rtol=1e-6, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- pads


def test_same_pads_matches_reference_geometry():
    from repro_torch.kernels.masked_act import _same_pads
    ref = reference()
    for size in range(1, 20):
        for stride in (1, 2):
            assert _same_pads(size, stride) == \
                ref.masked_act._same_pads(size, stride), (size, stride)
    # at stride 2 on an even size the pad is (0, 1), not (1, 1)
    assert _same_pads(16, 2) == (8, 0, 1)


def test_act_kinds_match_reference():
    from repro_torch.kernels import ref as tref
    ref = reference()
    x = np.random.default_rng(0).normal(size=(5, 33)).astype(np.float32) * 3
    for kind in KINDS:
        want = np.asarray(ref.ref._act(ref.jnp.asarray(x), kind))
        np.testing.assert_allclose(tref._act(_t(x), kind).numpy(), want,
                                   **GATE_TOL)
    with pytest.raises(ValueError):
        tref._act(_t(x), "tanh")


# ------------------------------------------------------------------- gate


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_poly", [False, True])
@pytest.mark.parametrize("shape", [(37, 203), (8, 128), (1, 5)])
def test_masked_act_2d_matches_pallas_interpret(kind, with_poly, shape):
    from repro_torch.kernels import ops
    ref = reference()
    rows, cols = shape
    rng = np.random.default_rng(5 + rows)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    m = (rng.random(cols) > 0.5).astype(np.float32)
    p = rng.normal(size=(3, cols)).astype(np.float32) * 0.3 \
        if with_poly else None
    want = ref.masked_act.masked_act_2d(
        ref.jnp.asarray(x), ref.jnp.asarray(m),
        None if p is None else ref.jnp.asarray(p), kind=kind,
        block_rows=16, block_cols=128, interpret=True)
    got = ops.masked_act(_t(x), _t(m), kind=kind,
                         poly=None if p is None else _t(p))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_poly", [False, True])
def test_masked_act_2d_batched_matches_pallas_interpret(kind, with_poly):
    from repro_torch.kernels import ops
    ref = reference()
    rng = np.random.default_rng(7)
    n, rows, cols = 3, 21, 77
    x = rng.normal(size=(n, rows, cols)).astype(np.float32)
    m = (rng.random((n, cols)) > 0.5).astype(np.float32)
    p = rng.normal(size=(3, cols)).astype(np.float32) * 0.3 \
        if with_poly else None
    want = ref.masked_act.masked_act_2d_batched(
        ref.jnp.asarray(x), ref.jnp.asarray(m),
        None if p is None else ref.jnp.asarray(p), kind=kind,
        block_rows=8, block_cols=128, interpret=True)
    got = ops.masked_act_batched(_t(x), _t(m), kind=kind,
                                 poly=None if p is None else _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE_TOL)


@pytest.mark.parametrize("kind", ["relu", "silu"])
def test_sited_batched_shared_activation_matches_broadcast(kind):
    """The first gate after a shared activation: the reference broadcasts x
    to (N, ...) before the stacked kernel; the port takes the un-stacked x
    (a stride-0 candidate axis) and must give the same stacked result."""
    from repro_torch.kernels import ops
    ref = reference()
    rng = np.random.default_rng(11)
    n, b, site = 4, 3, (5, 6, 7)
    x = rng.normal(size=(b,) + site).astype(np.float32)
    ms = (rng.random((n,) + site) > 0.4).astype(np.float32)
    xb = np.broadcast_to(x[None], (n,) + x.shape)
    want = ref.ops.masked_act_sited_batched(
        ref.jnp.asarray(xb), ref.jnp.asarray(ms), kind=kind,
        force_pallas=True, interpret=True)
    got_shared = ops.masked_act_sited_batched(_t(x), _t(ms), kind=kind)
    got_view = ops.masked_act_sited_batched(
        _t(x).unsqueeze(0).expand(n, -1, -1, -1, -1), _t(ms), kind=kind)
    got_full = ops.masked_act_sited_batched(_t(xb.copy()), _t(ms), kind=kind)
    assert got_shared.shape == (n, b) + site
    for got in (got_shared, got_view, got_full):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE_TOL)


def test_masked_act_sited_matches_reference_with_poly():
    from repro_torch.kernels import ops
    ref = reference()
    rng = np.random.default_rng(12)
    site = (4, 5, 6)
    x = rng.normal(size=(7,) + site).astype(np.float32)
    m = (rng.random(site) > 0.5).astype(np.float32)
    p = rng.normal(size=(3,) + site).astype(np.float32) * 0.2
    want = ref.ops.masked_act_sited(
        ref.jnp.asarray(x), ref.jnp.asarray(m), kind="gelu",
        poly=ref.jnp.asarray(p), force_pallas=True, interpret=True)
    got = ops.masked_act_sited(_t(x), _t(m), kind="gelu", poly=_t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE_TOL)


def test_batched_entry_rejects_mismatched_candidate_axis():
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="disagree on N"):
        ops.masked_act_batched(torch.zeros(2, 3, 4), torch.ones(3, 4))


# ------------------------------------------------------- fused gate -> conv


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (16, 16), (5, 6)])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_conv3x3_matches_pallas_interpret(stride, hw, kind):
    from repro_torch.kernels import ops
    ref = reference()
    rng = np.random.default_rng(2)
    h, wd = hw
    x = rng.normal(size=(2, h, wd, 6)).astype(np.float32)
    m = (rng.random((h, wd, 6)) > 0.5).astype(np.float32)
    w = rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
    want = ref.masked_act.masked_act_conv3x3(
        ref.jnp.asarray(x), ref.jnp.asarray(m), ref.jnp.asarray(w),
        stride=stride, kind=kind, interpret=True)
    got = ops.masked_act_conv3x3(_t(x), _t(m), _t(w), stride=stride,
                                 kind=kind)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shared_x", [False, True])
def test_fused_conv3x3_batched_matches_pallas_interpret(stride, shared_x):
    from repro_torch.kernels import ops
    ref = reference()
    rng = np.random.default_rng(3)
    n, b = 3, 2
    x = rng.normal(size=((b, 8, 7, 4) if shared_x else (n, b, 8, 7, 4))
                   ).astype(np.float32)
    ms = (rng.random((n, 8, 7, 4)) > 0.5).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    xj = np.broadcast_to(x[None], (n,) + x.shape) if shared_x else x
    want = ref.masked_act.masked_act_conv3x3_batched(
        ref.jnp.asarray(xj), ref.jnp.asarray(ms), ref.jnp.asarray(w),
        stride=stride, interpret=True)
    got = ops.masked_act_conv3x3_batched(_t(x), _t(ms), _t(w), stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
    # and candidate i equals the un-stacked entry on (x_i, mask_i)
    for i in range(n):
        one = ops.masked_act_conv3x3(_t(x if shared_x else x[i]), _t(ms[i]),
                                     _t(w), stride=stride)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), **CONV_TOL)


def test_conv_same_nhwc_matches_xla_same_padding():
    """The plain SAME convolution the model uses outside the kernels (stem,
    conv1, the 1x1 stride-2 projection) against lax.conv_general_dilated."""
    from repro_torch.kernels.ref import conv_same_nhwc
    ref = reference()
    rng = np.random.default_rng(4)
    for (kh, h, stride) in [(3, 8, 1), (3, 8, 2), (3, 7, 2), (1, 8, 2),
                            (1, 7, 2), (3, 4, 1)]:
        x = rng.normal(size=(2, h, h + 1, 3)).astype(np.float32)
        w = rng.normal(size=(kh, kh, 3, 4)).astype(np.float32)
        want = ref.jax.lax.conv_general_dilated(
            ref.jnp.asarray(x), ref.jnp.asarray(w), (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        got = conv_same_nhwc(_t(x), _t(w), stride)
        assert tuple(got.shape) == tuple(want.shape), (kh, h, stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
