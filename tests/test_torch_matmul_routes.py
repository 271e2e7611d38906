"""The fused gate→matmul's two routes on the card, and its bfloat16 contract
against the JAX package's kernels, on the CPU.

(a) ``kernels.masked_act.matmul_route`` is the one rule that sends a call on
a CUDA tensor to route A (``"wgmma"``, bfloat16 on the tensor cores) or
route B (``"fma"``, float32 FMA): the kernel library launches the route it
is given or refuses, and nothing falls back.  The rule is plain Python, so
it is tested here, where there is no card.

(b) bfloat16: the same numpy inputs, rounded to bfloat16, go through the
reference's Pallas kernels in interpret mode
(``masked_act_matmul_2d[_batched](..., interpret=True)``, which take
bfloat16 under the installed jax) and through the port's
``ops.masked_act_matmul[_batched]`` on CPU tensors in bfloat16, which take
the plain version.  Tolerance 1e-2 + 1e-2·|ref|, the bfloat16 tolerance of
the card's checks: one bfloat16 ulp is 2^-8 relative, the result is rounded
to bfloat16 once, and the gated operand may round one ulp apart where the
two frameworks round intermediate values differently; a wrong mask row, a
dropped ``mul`` or a mixed-up candidate is off by O(1).
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

KINDS = ["relu", "gelu", "silu", "sqrelu"]
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
BF, F32 = torch.bfloat16, torch.float32
ALIGNED = (0x1000, 0x2000, 0x3000, 0x4000, 0x5000)


@pytest.mark.parametrize("dtype, k, n_out, rows, n_cand, ptrs, route", [
    # the LM's shapes: StableLM-2-1.6B and RWKV-6 3B down-projections
    (BF, 5632, 2048, 1016, 4, ALIGNED, "wgmma"),
    (BF, 8960, 2560, 1024, 1, ALIGNED, "wgmma"),
    (BF, 96, 72, 37, 3, ALIGNED, "wgmma"),
    (BF, 8, 8, 1, 1, ALIGNED, "wgmma"),
    # no mul: the missing pointer is not checked
    (BF, 96, 72, 37, 3, ALIGNED[:4] + (None,), "wgmma"),
    # every float32 call takes route B, aligned or not
    (F32, 5632, 2048, 1016, 4, ALIGNED, "fma"),
    (F32, 203, 77, 37, 1, (0x1004,), "fma"),
    # bfloat16 that TMA cannot copy: a row pitch not a multiple of 16 bytes
    (BF, 203, 72, 37, 1, ALIGNED, "fma"),
    (BF, 96, 77, 37, 1, ALIGNED, "fma"),
    (BF, 100, 72, 37, 1, ALIGNED, "fma"),
    # ... an operand 8 bytes off a 16-byte boundary (x, then mul)
    (BF, 96, 72, 37, 1, (0x1008,) + ALIGNED[1:], "fma"),
    (BF, 96, 72, 37, 1, ALIGNED[:4] + (0x5008,), "fma"),
    # ... more stacked rows than a TMA coordinate holds
    (BF, 64, 64, 2 ** 29, 4, ALIGNED, "fma"),
    (BF, 64, 64, 2 ** 29 - 1, 4, ALIGNED, "wgmma"),
])
def test_route_rule(dtype, k, n_out, rows, n_cand, ptrs, route):
    from repro_torch.kernels import masked_act as K
    assert K.matmul_route(dtype, k, n_out, rows, n_cand, ptrs) == route
    assert route in K.MATMUL_ROUTES


@pytest.mark.parametrize("dtype, k, n_out, rows, n_cand, err", [
    (torch.float16, 64, 64, 8, 1, TypeError),
    (torch.float64, 64, 64, 8, 1, TypeError),
    (BF, 0, 64, 8, 1, ValueError),
    (F32, 64, 0, 8, 1, ValueError),
    (BF, 64, 64, 8, 0, ValueError),
])
def test_route_rule_refuses(dtype, k, n_out, rows, n_cand, err):
    from repro_torch.kernels import masked_act as K
    with pytest.raises(err):
        K.matmul_route(dtype, k, n_out, rows, n_cand, ALIGNED)


def test_route_counts_reset_with_launch_counts():
    from repro_torch.kernels import build
    assert set(build.route_counts) == {
        f"{n}:{r}" for n in ("masked_act_matmul_2d",
                             "masked_act_matmul_2d_batched")
        for r in ("fma", "wgmma")} | {
        f"{n}:{r}" for n in ("masked_act_conv3x3",
                             "masked_act_conv3x3_batched")
        for r in ("fma", "tf32x3")} | {
        f"{n}:{r}" for n in ("rwkv6_scan", "rwkv6_scan_bwd")
        for r in ("serial", "tf32x3")}
    build.route_counts["masked_act_matmul_2d:wgmma"] += 3
    build.reset_launch_counts()
    assert not any(build.route_counts.values())


def _bf16(a):
    """numpy float32 -> the bfloat16 values both frameworks get."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(BF)


def _inputs(seed, lead, k=64, n_out=40, with_mul=True):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=lead + (k,)))
    w = _bf16(rng.normal(size=(k, n_out)) * k ** -0.5)
    mul = _bf16(rng.normal(size=lead + (k,))) if with_mul else None
    return rng, x, w, mul


def _jnp(ref, t):
    return ref.jnp.asarray(t.float().numpy(), dtype=ref.jnp.bfloat16)


def _close(got, want):
    assert got.dtype == BF and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_mul", [False, True])
def test_bf16_matmul_matches_pallas_interpret(kind, with_mul):
    """Kernel 3 in bfloat16: ragged rows (37 against blocks of 16)."""
    from repro_torch.kernels import ops
    ref = reference()
    rng, x, w, mul = _inputs(10, (37,), with_mul=with_mul)
    m = (rng.random(64) > 0.5).astype(np.float32)
    want = ref.masked_act.masked_act_matmul_2d(
        _jnp(ref, x), ref.jnp.asarray(m), _jnp(ref, w),
        None if mul is None else _jnp(ref, mul), kind=kind, block_rows=16,
        interpret=True)
    got = ops.masked_act_matmul(x, torch.from_numpy(m), w, mul, kind=kind)
    assert got.shape == (37, 40)
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_mul", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_bf16_matmul_batched_matches_pallas_interpret(kind, with_mul,
                                                      shared):
    """Kernel 4 in bfloat16: three candidates; ``shared`` gives x and mul as
    stride-0 views of one tensor, against the reference's broadcast."""
    from repro_torch.kernels import ops
    ref = reference()
    n = 3
    rng, x, w, mul = _inputs(11, (1 if shared else n, 37),
                             with_mul=with_mul)
    masks = (rng.random((n, 64)) > 0.5).astype(np.float32)
    tx = x.expand(n, 37, 64) if shared else x
    tm = None if mul is None else (mul.expand(n, 37, 64) if shared else mul)
    want = ref.masked_act.masked_act_matmul_2d_batched(
        _jnp(ref, tx), ref.jnp.asarray(masks), _jnp(ref, w),
        None if tm is None else _jnp(ref, tm), kind=kind, block_rows=16,
        interpret=True)
    got = ops.masked_act_matmul_batched(tx, torch.from_numpy(masks), w, tm,
                                        kind=kind)
    assert got.shape == (n, 37, 40)
    _close(got, want)
