"""The port's fused gate→matmul (TPU kernels 3 and 4) against the JAX
package's, on the CPU.

The same numpy inputs, from a seed, go through the reference's Pallas
kernels in interpret mode (``masked_act_matmul_2d[_batched](...,
interpret=True)``, as ``tests/test_fused_kernels.py`` runs them) and through
the port's entry points in ``repro_torch.kernels.ops``, which on a CPU
tensor take the plain PyTorch version — the version the CUDA kernels are
held against on the card by ``chip_smoke.py``.

Tolerance 1e-5: the products are summed in another order than the
reference's (48 terms of O(1) here, ~1e-6 apart), and a wrong mask row, a
dropped ``mul`` or a mixed-up candidate would show at 1e-1.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

KINDS = ["relu", "gelu", "silu", "sqrelu"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, lead, k=48, n_out=24, with_mul=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    w = (rng.normal(size=(k, n_out)) * k ** -0.5).astype(np.float32)
    mul = rng.normal(size=lead + (k,)).astype(np.float32) \
        if with_mul else None
    return rng, x, w, mul


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_mul", [False, True])
def test_masked_act_matmul_matches_pallas_interpret(kind, with_mul):
    """Kernel 3: ragged rows (37 against blocks of 16)."""
    from repro_torch.kernels import ops
    ref = reference()
    rng, x, w, mul = _inputs(0, (37,), with_mul=with_mul)
    m = (rng.random(48) > 0.5).astype(np.float32)
    j = ref.jnp.asarray
    want = ref.masked_act.masked_act_matmul_2d(
        j(x), j(m), j(w), None if mul is None else j(mul), kind=kind,
        block_rows=16, interpret=True)
    got = ops.masked_act_matmul(_t(x), _t(m), _t(w),
                                None if mul is None else _t(mul), kind=kind)
    assert got.shape == (37, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masked_act_matmul_keeps_leading_dims():
    """(B, S, K) in, (B, S, N_out) out: rows are every leading position."""
    from repro_torch.kernels import ops
    ref = reference()
    rng, x, w, mul = _inputs(1, (3, 13))
    m = (rng.random(48) > 0.5).astype(np.float32)
    j = ref.jnp.asarray
    want = ref.masked_act.masked_act_matmul_2d(
        j(x.reshape(39, 48)), j(m), j(w), j(mul.reshape(39, 48)),
        kind="silu", block_rows=16, interpret=True)
    got = ops.masked_act_matmul(_t(x), _t(m), _t(w), _t(mul), kind="silu")
    assert got.shape == (3, 13, 24)
    np.testing.assert_allclose(got.numpy().reshape(39, 24),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_mul", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_masked_act_matmul_batched_matches_pallas_interpret(kind, with_mul,
                                                            shared):
    """Kernel 4: three candidates, ragged rows; ``shared`` gives x and mul
    as stride-0 views of one tensor, as the first FFN after a cached prefix
    does, against the reference's explicit broadcast."""
    from repro_torch.kernels import ops
    ref = reference()
    n = 3
    rng, x, w, mul = _inputs(2, (1 if shared else n, 37), with_mul=with_mul)
    masks = (rng.random((n, 48)) > 0.5).astype(np.float32)
    xb = np.broadcast_to(x, (n, 37, 48))
    mb = None if mul is None else np.broadcast_to(mul, (n, 37, 48))
    j = ref.jnp.asarray
    want = ref.masked_act.masked_act_matmul_2d_batched(
        j(xb), j(masks), j(w), None if mb is None else j(mb), kind=kind,
        block_rows=16, interpret=True)
    tx = _t(x).expand(n, 37, 48) if shared else _t(x)
    tm = None if mul is None else (
        _t(mul).expand(n, 37, 48) if shared else _t(mul))
    if shared:
        assert tx.stride(0) == 0
    got = ops.masked_act_matmul_batched(tx, _t(masks), _t(w), tm, kind=kind)
    assert got.shape == (n, 37, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # candidate b under mask row b equals the un-stacked entry
    for b in range(n):
        one = ops.masked_act_matmul(tx[b], _t(masks[b]), _t(w),
                                    None if tm is None else tm[b],
                                    kind=kind)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


def test_plain_versions_match_reference_oracle():
    from repro_torch.kernels import ref as tref
    ref = reference()
    rng, x, w, mul = _inputs(3, (5, 7))
    m = (rng.random(48) > 0.5).astype(np.float32)
    j = ref.jnp.asarray
    for kind in KINDS:
        want = ref.ref.masked_act_matmul_ref(j(x), j(m), j(w), j(mul),
                                             kind=kind)
        got = tref.masked_act_matmul_ref(_t(x), _t(m), _t(w), _t(mul),
                                         kind=kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batched_entry_rejects_mismatched_candidate_axis():
    from repro_torch.kernels import ops
    x = torch.zeros(2, 5, 8)
    w = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="disagree on N"):
        ops.masked_act_matmul_batched(x, torch.ones(3, 8), w)
    with pytest.raises(ValueError, match="disagree on N"):
        ops.masked_act_matmul_batched(x, torch.ones(2, 8), w,
                                      torch.zeros(3, 5, 8))


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA wrappers never serve a CPU tensor — ops does, through the
    plain version — and a refused call adds nothing to the launch counts."""
    from repro_torch.kernels import build, masked_act as K
    assert {"masked_act_matmul_2d",
            "masked_act_matmul_2d_batched"} <= set(build.launch_counts)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_matmul_2d(torch.zeros(4, 8), torch.ones(8),
                               torch.zeros(8, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.masked_act_matmul_2d_batched(torch.zeros(2, 4, 8),
                                       torch.ones(2, 8), torch.zeros(8, 3))
    assert build.launch_counts == before


def test_candidate_stride_of_shared_and_stacked_operands():
    """What the batched wrapper hands the kernel as the candidate stride:
    0 for an expanded shared tensor, rows*K for a stacked one; anything
    else is refused."""
    from repro_torch.kernels import masked_act as K, ops
    one = torch.zeros(1, 5, 8)
    assert K._cand_stride("f", "x", one.expand(3, 5, 8), 3, 40) == 0
    assert K._cand_stride("f", "x", torch.zeros(3, 5, 8), 3, 40) == 40
    with pytest.raises(ValueError, match="candidate stride"):
        K._cand_stride("f", "x", torch.zeros(3, 8, 5).transpose(1, 2), 3,
                       40)
    # ops keeps a shared (N, B, S, K) view at stride 0 when it folds rows
    shared = torch.zeros(2, 3, 8).unsqueeze(0).expand(4, 2, 3, 8)
    assert ops._rows_view(shared, 4, 8).stride(0) == 0
    assert ops._rows_view(shared, 4, 8).shape == (4, 6, 8)
