"""The RWKV-6 scan's gradient on the CPU: the plain backward
(``kernels.ref.rwkv6_scan_bwd_ref``, what ``kernels.ops.RWKV6ScanFn`` runs
for a CPU tensor and what ``chip_smoke.py`` holds the CUDA kernel
``csrc/rwkv6_scan_bwd.cu`` to on the card) against autograd through the
token-serial recurrence in float64, and against ``jax.grad`` of the
reference's jnp ``linattn_chunked`` in float32.

Tolerances: 1e-10 in float64 (the same recurrence, summed in another
order); ``SCAN_TOL`` (3e-4, the reference's own scan tolerance,
``tests/test_torch_rwkv.py``) against the reference, whose chunked form
divides by in-chunk decay products.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(seed, bh, T, K, V, *, heads=0, strong=False, dtype=np.float32):
    """The reference test's distribution (``test_kernels.py:233``), or
    strong decays w = exp(-exp(U(-1, 3))); u a (BH, K) array or, with
    ``heads``, an (H, K) table; a random state; dy and ds_end."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(bh, T, K)) * 0.5
    k = rng.normal(size=(bh, T, K)) * 0.5
    v = rng.normal(size=(bh, T, V))
    w = np.exp(-np.exp(rng.uniform(-1.0, 3.0, size=(bh, T, K)))) if strong \
        else rng.uniform(0.7, 0.999, size=(bh, T, K))
    u = rng.normal(size=(heads or bh, K)) * 0.3
    s0 = rng.normal(size=(bh, K, V)) * 0.1
    dy = rng.normal(size=(bh, T, V))
    ds_end = rng.normal(size=(bh, K, V))
    return [a.astype(dtype) for a in (r, k, v, w, u, s0, dy, ds_end)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _autograd_serial(r, k, v, w, u, s0, dy, ds_end):
    """Gradients of <y, dy> + <S_end, ds_end> through the token loop."""
    from repro_torch.kernels import ref
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    y, s = ref.rwkv6_serial_ref(*leaves)
    loss = (y * dy).sum() + (0.0 if ds_end is None else (s * ds_end).sum())
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("T,K,V,heads", [(1, 4, 4, 0), (13, 8, 8, 0),
                                         (32, 16, 8, 2), (40, 8, 16, 3),
                                         (24, 64, 64, 0)])
def test_plain_backward_matches_autograd_of_the_serial_loop(T, K, V, heads):
    from repro_torch.kernels import ref
    args = [_t(a) for a in _inputs(1, 6, T, K, V, heads=heads,
                                   dtype=np.float64)]
    got = ref.rwkv6_scan_bwd_ref(*args)
    want = _autograd_serial(*args)
    for name, g, w_ in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name,
                                   **F64_TOL)


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 32), (64, 16)])
def test_plain_backward_matches_jax_grad_of_linattn_chunked(T, chunk):
    """The reference's model differentiates its jnp ``linattn_chunked``
    (``src/repro/models/ssm.py:33``) with an (H, K) bonus table over
    (B, H, ...) rows: the same gradients from the port's rule."""
    from repro_torch.kernels import ref
    R = reference()
    jnp = R.jnp
    B, H, K, V = 2, 3, 8, 16
    r, k, v, w, u, s0, dy, ds_end = _inputs(2, B * H, T, K, V, heads=H)

    def heads4(a):
        return jnp.asarray(a.reshape((B, H) + a.shape[1:]))

    def f(r_, k_, v_, w_, u_, s_):
        return R.ssm.linattn_chunked(r_, k_, v_, w_, u_, s_, chunk=chunk)
    primals = [heads4(a) for a in (r, k, v, w)] + [jnp.asarray(u),
                                                   heads4(s0)]
    _, vjp = R.jax.vjp(f, *primals)
    want = [np.asarray(g) for g in vjp((heads4(dy), heads4(ds_end)))]
    got = ref.rwkv6_scan_bwd_ref(*map(_t, (r, k, v, w, u, s0, dy, ds_end)))
    for name, g, w_ in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w_.reshape(g.shape),
                                   err_msg=name, **SCAN_TOL)


def test_u_table_stride0_state_and_no_final_gradient():
    """An (H, K) table's gradient is the per-row one summed over the rows
    of each head; a stride-0 zero state and a None ds_end give what the
    full zero state and a zero ds_end give."""
    from repro_torch.kernels import ref
    bh, T, K, V, H = 6, 16, 8, 8, 3
    r, k, v, w, u, _, dy, _ = map(_t, _inputs(3, bh, T, K, V, heads=H))
    zeros = torch.zeros((bh, K, V))
    shared = torch.zeros((1, K, V)).expand(bh, K, V)
    full_u = u.repeat(bh // H, 1)
    got = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, shared, dy)
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, full_u, zeros, dy, zeros)
    for name, g, w_ in zip(NAMES, got, want):
        if name == "du":
            w_ = w_.reshape(bh // H, H, K).sum(0)
        assert g.shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # rows of one head summed in increasing order, as the CUDA reduction
    per_row = want[4]
    acc = per_row[:H].clone()
    for b0 in range(H, bh, H):
        acc = acc + per_row[b0:b0 + H]
    assert torch.equal(got[4], acc)


def test_finite_under_strong_decay():
    """Decays down to 2e-9: the reference's chunked form divides by their
    in-chunk products and is not finite; the backward recomputes states
    and never divides, so its gradients are finite and agree with float64
    autograd through the token loop."""
    from repro_torch.kernels import ref
    args = _inputs(4, 4, 64, 16, 16, strong=True)
    y, _ = ref.rwkv6_scan_ref(*map(_t, args[:6]), chunk=32)
    assert not torch.isfinite(y).all()
    got = ref.rwkv6_scan_bwd_ref(*map(_t, args))
    want = _autograd_serial(*(_t(a.astype(np.float64)) for a in args))
    for name, g, w_ in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        scale = float(w_.abs().max())
        assert float((g.double() - w_).abs().max()) <= 1e-5 * scale, name


def test_scan_fn_on_the_cpu():
    """Under autograd ``ops.rwkv6`` goes through ``RWKV6ScanFn``: its
    forward is the chunked plain version's, its gradients the plain
    backward's (u as the time-mix passes it, an (H, K) table; the state a
    stride-0 zero expand that needs none)."""
    from repro_torch.kernels import ops, ref
    bh, T, K, V, H = 6, 32, 8, 8, 3
    r, k, v, w, u, _, dy, ds_end = map(_t, _inputs(5, bh, T, K, V, heads=H))
    state = torch.zeros((1, K, V)).expand(bh, K, V)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, s = ops.rwkv6(*leaves, state, chunk=16)
    assert type(y.grad_fn).__name__ == "RWKV6ScanFnBackward"
    want_y, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, state, chunk=16)
    assert torch.equal(y.detach(), want_y) and torch.equal(s.detach(), want_s)
    grads = torch.autograd.grad((y * dy).sum() + (s * ds_end).sum(), leaves)
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_end)
    for name, g, w_ in zip(NAMES, grads, want):
        assert torch.equal(g, w_), name
    # only y reaches the loss: the final state's gradient is None
    y, s = ops.rwkv6(*leaves, state, chunk=16)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy)
    for name, g, w_ in zip(NAMES, grads, want):
        assert torch.equal(g, w_), name
    # without a gradient being recorded: the plain forward, no graph
    y, _ = ops.rwkv6(r, k, v, w, u, state, chunk=16)
    assert y.grad_fn is None
    with pytest.raises(TypeError, match="float32"):
        ops.rwkv6(*(t.double() for t in leaves), state.double(), chunk=16)


def test_cuda_wrapper_refuses_cpu_and_bfloat16_tensors():
    """The backward's CUDA wrapper serves no CPU tensor (RWKV6ScanFn takes
    the plain version there) and no bfloat16, counts no launch, and raises
    under autograd like every raw wrapper."""
    from repro_torch.kernels import build, rwkv6_scan as RS
    args = list(map(_t, _inputs(6, 2, 8, 4, 4)))
    before = dict(build.launch_counts)
    assert "rwkv6_scan_bwd" in before
    with pytest.raises(ValueError, match="CUDA tensor"):
        RS.rwkv6_scan_bwd(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RS.rwkv6_scan_bwd(*args[:7])
    with pytest.raises(TypeError, match="float32"):
        RS.rwkv6_scan_bwd(*(a.to(torch.bfloat16) for a in args))
    with pytest.raises(RuntimeError, match="requires grad"):
        RS.rwkv6_scan_bwd(args[0].requires_grad_(True), *args[1:])
    assert build.launch_counts == before
