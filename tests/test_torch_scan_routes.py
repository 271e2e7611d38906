"""The RWKV-6 scan's two routes on the card, and route C's arithmetic
against the JAX package's kernel, on the CPU.

(a) ``kernels.rwkv6_scan.scan_route`` is the one rule that sends a scan on
CUDA tensors to route C (``"tf32x3"``: chunks of 16 tokens, the products on
the TF32 tensor cores with each float32 operand split into a big and a small
part, no division by a decay product) or route S (``"serial"``: token by
token).  The kernel library launches the route it is given or refuses;
nothing falls back.  The rule is plain Python, so it is tested here, where
there is no card.

(b) ``ref.rwkv6_scan_tf32x3_ref``, a plain emulation of route C's
arithmetic (its chunk, anchors, running decay products, split operands and
per-step sums), against the reference's Pallas kernel in interpret mode and
its token-serial oracle on the same numpy inputs, within the scan tolerance
3e-4 + 3e-4·|ref| (the reference's own, ``test_kernels.py``); its error
against the float64 token loop stays within 4× the plain version's, the
contract the card holds route C to.  Under strong decay the plain version
(the reference's chunked arithmetic, which divides by in-chunk decay
products) is not finite, while the emulation is, within 4× of the float32
token loop's error.  On the CPU ``ops`` still take the plain version.
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
ERR_RATIO = 4.0
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, bh, T, K, V, strong=False):
    """The reference test's distribution (``test_kernels.py:233``); with
    ``strong``, decays w = exp(-exp(U(-1, 3))), down to 2e-9."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.normal(size=(bh, T, K)).astype(f) * 0.5
    k = rng.normal(size=(bh, T, K)).astype(f) * 0.5
    v = rng.normal(size=(bh, T, V)).astype(f)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-1, 3, size=(bh, T, K)))).astype(f)
    else:
        w = rng.uniform(0.7, 0.999, size=(bh, T, K)).astype(f)
    u = rng.normal(size=(bh, K)).astype(f) * 0.3
    s0 = rng.normal(size=(bh, K, V)).astype(f) * 0.1
    return r, k, v, w, u, s0


def _err64(got, exact):
    return max(float((g.double() - e).abs().max())
               for g, e in zip(got, exact))


# ------------------------------------------------------------- route rule


@pytest.mark.parametrize("dtype, bh, T, K, V, want", [
    # the RWKV-6 3B path: stacked over 4 candidates, and un-stacked
    (F32, 1280, 128, 64, 64, "tf32x3"),
    (F32, 320, 128, 64, 64, "tf32x3"),
    (F32, 64, 96, 64, 64, "tf32x3"),
    # the reference test's shapes
    (F32, 4, 32, 8, 8, "tf32x3"),
    (F32, 4, 64, 16, 32, "tf32x3"),
    (F32, 4, 64, 8, 16, "tf32x3"),
    # ragged: T not a multiple of 16, K and V not multiples of 4 (4-byte
    # copies instead of TMA), one token, no token, one row
    (F32, 6, 17, 16, 16, "tf32x3"),
    (F32, 3, 40, 5, 7, "tf32x3"),
    (F32, 2, 1, 1, 1, "tf32x3"),
    (F32, 2, 0, 64, 64, "tf32x3"),
    (F32, 1, 16, 64, 1, "tf32x3"),
    # refusals: no route takes another dtype, or K, V outside [1, 64]
    (torch.float64, 4, 32, 8, 8, TypeError),
    (torch.bfloat16, 4, 32, 8, 8, TypeError),
    (F32, 4, 32, 0, 8, ValueError),
    (F32, 4, 32, 65, 8, ValueError),
    (F32, 4, 32, 8, 0, ValueError),
    (F32, 4, 32, 8, 65, ValueError),
    (F32, -1, 32, 8, 8, ValueError),
])
def test_scan_route_rule(dtype, bh, T, K, V, want):
    from repro_torch.kernels import rwkv6_scan as RS
    if isinstance(want, str):
        assert RS.scan_route(dtype, bh, T, K, V) == want
        assert want in RS.SCAN_ROUTES
    else:
        with pytest.raises(want):
            RS.scan_route(dtype, bh, T, K, V)


def test_scan_routes_are_counted():
    """Both routes have a count beside the kernel's launch count, reset with
    it; the library's entry takes the route's code."""
    from repro_torch.kernels import build, rwkv6_scan as RS
    assert RS.SCAN_ROUTES == {"serial": 0, "tf32x3": 1}
    assert {"rwkv6_scan:serial", "rwkv6_scan:tf32x3"} <= set(
        build.route_counts)
    build.route_counts["rwkv6_scan:tf32x3"] += 2
    build.reset_launch_counts()
    assert build.route_counts["rwkv6_scan:tf32x3"] == 0


# ------------------------------------------------ route C's arithmetic


@pytest.mark.parametrize("bh, T, K, V, chunk", [
    (4, 32, 8, 8, 8), (4, 64, 16, 32, 16), (4, 64, 8, 16, 32),
    (6, 17, 16, 16, 17), (3, 40, 5, 7, 8)])
def test_tf32x3_emulation_matches_pallas_interpret_and_oracle(bh, T, K, V,
                                                              chunk):
    from repro_torch.kernels import ref as T_ref
    ref = reference()
    args = _inputs(3, bh, T, K, V)
    j = [ref.jnp.asarray(a) for a in args]
    y_pl, s_pl = ref.rwkv6_scan.rwkv6_scan(*j, chunk=chunk, interpret=True)
    y_or, s_or = ref.ops._rwkv6_scan_jnp(*j)
    y, s = T_ref.rwkv6_scan_tf32x3_ref(*map(_t, args), chunk=chunk)
    assert y.shape == (bh, T, V) and s.shape == (bh, K, V)
    assert y.dtype == s.dtype == F32
    for want_y, want_s in ((y_pl, s_pl), (y_or, s_or)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SCAN_TOL)
    # the card's contract: within 4x the plain version's error against the
    # float64 token loop
    exact = T_ref.rwkv6_serial_ref(*(_t(a).double() for a in args))
    plain = T_ref.rwkv6_scan_ref(*map(_t, args), chunk=chunk)
    assert _err64((y, s), exact) <= ERR_RATIO * _err64(plain, exact)


def test_tf32x3_emulation_refuses_what_the_reference_refuses():
    from repro_torch.kernels import ref as T_ref
    args = list(map(_t, _inputs(6, 2, 40, 8, 8)))
    with pytest.raises(ValueError, match="multiple"):
        T_ref.rwkv6_scan_tf32x3_ref(*args, chunk=32)


def test_strong_decay_emulation_is_finite_where_the_plain_version_is_not():
    """w = exp(-exp(U(-1, 3))) at the path's head width: the reference's
    chunked arithmetic divides by in-chunk decay products that underflow
    (its own behaviour: not finite), route C's arithmetic never divides and
    stays within tolerance of the float64 token loop and within 4x the
    float32 token loop's error."""
    from repro_torch.kernels import ref as T_ref
    args = list(map(_t, _inputs(0, 8, 128, 64, 64, strong=True)))
    plain = T_ref.rwkv6_scan_ref(*args, chunk=32)
    assert not bool(torch.isfinite(plain[0]).all())
    y, s = T_ref.rwkv6_scan_tf32x3_ref(*args, chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    exact = T_ref.rwkv6_serial_ref(*(a.double() for a in args))
    for got, want in zip((y, s), exact):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SCAN_TOL)
    serial = T_ref.rwkv6_serial_ref(*args)
    assert _err64((y, s), exact) <= ERR_RATIO * _err64(serial, exact)


@pytest.mark.parametrize("decay", ["reference", "strong", "edges"])
def test_every_decay_factor_is_at_most_one(decay):
    """Every decay factor the emulation forms — the sub-block prefix and
    suffix products, the whole products, the anchored products of r and k,
    the chunk's decay and each in-sub-block pair's running product — lies
    in [0, 1] for w in [0, 1], exact zeros and ones included."""
    from repro_torch.kernels import ref as T_ref
    r, k, v, w, u, s0 = _inputs(11, 4, 40, 16, 8, strong=decay == "strong")
    if decay == "edges":
        w = np.where(np.random.default_rng(12).random(w.shape) < 0.3,
                     np.float32(0.0), np.float32(1.0))
    factors = []
    y, s = T_ref.rwkv6_scan_tf32x3_ref(*map(_t, (r, k, v, w, u, s0)),
                                       chunk=8, factors=factors)
    assert factors and bool(torch.isfinite(y).all())
    for f in factors:
        assert bool((f <= 1.0).all()) and bool((f >= 0.0).all())
