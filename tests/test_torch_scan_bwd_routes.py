"""The RWKV-6 scan's backward on its two routes, and route ``"tf32x3"``'s
arithmetic on the CPU.

(a) ``kernels.rwkv6_scan.scan_bwd_route`` is the one rule that sends a
backward on CUDA tensors to ``"tf32x3"`` (``csrc/rwkv6_scan_bwd_sm90.cu``:
chunks of 16 tokens walked last to first, the chunk products on the TF32
tensor cores with each float32 operand split into a big and a small part, no
division by a decay) or ``"serial"`` (``csrc/rwkv6_scan_bwd.cu``: token by
token).  The kernel library launches the route it is given or refuses;
nothing falls back.  The rule is plain Python, so it is tested here, where
there is no card.

(b) :func:`_tf32x3_bwd`, an emulation in this file of the route's chunk
arithmetic — the forward pass that keeps the state entering every chunk,
the carried state gradient ``dS_start = diag(F) dS_end + R~ᵀ dY``, the
products with ``S0`` and ``dS_end`` and ``dY Vᵀ`` in 8-deep steps of split
operands, the in-chunk scores inside each sub-block of 8 on the CUDA cores
and across the two anchored at their boundary, and dr, dk and dw from
running decay products (dw's four terms: ``S0 × dS_end`` through one
K-vector a chunk, the two cross terms through ``V dS_endᵀ`` and
``dY S0ᵀ``, the in-chunk pairs ``s < t < s'`` by a forward recursion and a
Horner sum) — against the plain backward in float64 at 1e-10, and in
float32 against ``jax.grad`` of the reference's jnp ``linattn_chunked``
within the scan tolerance (``tests/test_torch_scan_bwd.py``).  Under strong
decay it stays finite where the reference's chunked form is not, and every
decay factor it forms lies in [0, 1].
"""
import numpy as np
import pytest
import torch

from test_torch_helpers import reference

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
ERR_RATIO = 4.0
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
F32 = torch.float32
C = 16          # the route's chunk (csrc/rwkv6_scan_bwd_sm90.cu kC)
SUB = 8         # its two sub-blocks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, bh, T, K, V, *, heads=0, strong=False, dtype=np.float32):
    """As ``tests/test_torch_scan_bwd.py``: the reference test's
    distribution, or strong decays w = exp(-exp(U(-1, 3))); u a (BH, K)
    array or an (H, K) table; a random state; dy and ds_end."""
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


# ------------------------------------------------ the route's arithmetic


def _split(x):
    """The big and small TF32 parts of a float32 operand; a float64 one is
    kept whole (its algebra is what float64 checks)."""
    from repro_torch.kernels import ref
    if x.dtype == torch.float64:
        return x, torch.zeros_like(x)
    return ref.split_tf32(x)


def _mm(a, b):
    """``a @ b`` as the tensor cores take it: the contracted axis in steps
    of 8, each operand of a step split, the step taken as
    hi·lo + lo·hi + hi·hi into a fresh sum added to the float32 total."""
    out = None
    for j in range(0, a.shape[-1], 8):
        a_hi, a_lo = _split(a[..., j:j + 8])
        b_hi, b_lo = _split(b[..., j:j + 8, :])
        p = a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi
        out = p if out is None else out + p
    return out


def _fma(a, b, c):
    """a·b + c rounded once, as ``fmaf``."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _tf32x3_bwd(r, k, v, w, u, state, dy, ds_end=None, factors=None):
    """Route ``"tf32x3"`` of ``rwkv6_scan_bwd``, emulated.  Per chunk of 16
    tokens (t, s local), with P_t = prod_{j<t} w_j, Q_t = prod_{t<j<16} w_j,
    F = prod_j w_j — every one a running product, never divided by — and
    R~ = r·P, K~ = k·Q, S0 the state entering the chunk, D = dS_end the
    gradient of the state leaving it:

      Sc[t, s] = r_t · (k_s ⊙ prod_{s<j<t} w_j) (t > s),
                 r_s · (u ⊙ k_s) (t = s): inside each sub-block of 8 a
                 running product on the CUDA cores; across them
                 (r_t ⊙ P'_t) · (k_s ⊙ Q'_s), P'_t the product from 8 to
                 t − 1 and Q'_s the one from s + 1 to 7
      H = dY Vᵀ
      M2 = dY S0ᵀ,  M1 = V Dᵀ,  g = Σ_v D ⊙ S0
      dv = K~ D + Scᵀ dY
      dr_i = P_i M2_i + G_i[i] + H[i, i] u k_i,
             G_{i+1}[t] = w_i G_i[t] + k_i H[t, i]
      dk_i = Q_i M1_i + L_i[i] + H[i, i] u r_i,
             L_{i-1}[s] = w_i L_i[s] + r_i H[i, s]
      dw_i = Q_i (P_i g + c_i) + Σ_{t>i} prod_{i<j<t} w_j r_t G_i[t]
             + P_i e_i,
             c_{i+1} = w_i c_i + k_i M1_i,  e_{i-1} = w_i e_i + r_i M2_i
      D   <- diag(F) D + R~ᵀ dY

    Shapes and results as ``ref.rwkv6_scan_bwd_ref`` (any T: a padded
    token decays nothing and reads zeros).  ``factors``, if a list, receives
    every decay factor formed."""
    from repro_torch.kernels import ref
    dt = r.dtype
    bh, T, K = r.shape
    V = v.shape[-1]
    n = -(-T // C)
    record = factors.append if factors is not None else (lambda x: None)

    def pad(t, fill=0.0):
        out = torch.full((bh, n * C, t.shape[-1]), fill, dtype=dt)
        out[:, :T] = t
        return out
    rp, kp, vp, dyp, wp = pad(r), pad(k), pad(v), pad(dy), pad(w, 1.0)
    ur = ref._rwkv6_u_rows(u, bh)

    def decays(wc):
        P, Q = torch.ones_like(wc), torch.ones_like(wc)
        for t in range(1, C):
            P[:, t] = P[:, t - 1] * wc[:, t - 1]
        for t in range(C - 2, -1, -1):
            Q[:, t] = Q[:, t + 1] * wc[:, t + 1]
        F = P[:, C - 1] * wc[:, C - 1]
        for x in (P, Q, F):
            record(x)
        return P, Q, F

    # the forward pass: the state entering every chunk
    S = state.expand(bh, K, V).clone()
    starts = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        starts.append(S)
        _, Q, F = decays(wp[:, sl])
        S = _fma(F[..., None], S, _mm((kp[:, sl] * Q).transpose(1, 2),
                                      vp[:, sl]))

    D = torch.zeros((bh, K, V), dtype=dt) if ds_end is None \
        else ds_end.expand(bh, K, V).clone()
    dr, dk, dw = (torch.zeros((bh, n * C, K), dtype=dt) for _ in range(3))
    dv = torch.zeros((bh, n * C, V), dtype=dt)
    du_rows = torch.zeros((bh, K), dtype=dt)
    for c in range(n - 1, -1, -1):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, wc, dyc = rp[:, sl], kp[:, sl], vp[:, sl], wp[:, sl], \
            dyp[:, sl]
        S0 = starts[c]
        P, Q, F = decays(wc)
        # the in-chunk scores: inside each sub-block of 8 plain sums, each
        # pair weighted by a running product; the second sub-block's
        # targets against the first's sources anchored at their boundary,
        # (r·P')(k·Q')ᵀ, on the tensor cores
        Sc = torch.zeros((bh, C, C), dtype=dt)
        for b0 in (0, SUB):
            for s in range(b0, b0 + SUB):
                E, run = kc[:, s], torch.ones_like(kc[:, s])
                Sc[:, s, s] = (rc[:, s] * (ur * kc[:, s])).sum(-1)
                for t in range(s + 1, b0 + SUB):
                    Sc[:, t, s] = (rc[:, t] * E).sum(-1)
                    E = E * wc[:, t]
                    run = run * wc[:, t]        # the factor E carries
                    record(run)
        P8, Q8 = torch.ones_like(wc[:, SUB:]), torch.ones_like(wc[:, :SUB])
        for t in range(1, SUB):
            P8[:, t] = P8[:, t - 1] * wc[:, SUB + t - 1]
        for s in range(SUB - 2, -1, -1):
            Q8[:, s] = Q8[:, s + 1] * wc[:, s + 1]
        for x in (P8, Q8):
            record(x)
        Sc[:, SUB:, :SUB] = _mm(rc[:, SUB:] * P8,
                                (kc[:, :SUB] * Q8).transpose(1, 2))
        H = _mm(dyc, vc.transpose(1, 2))          # dY Vᵀ
        g = (D * S0).sum(-1)
        M2 = _mm(dyc, S0.transpose(1, 2))
        M1 = _mm(vc, D.transpose(1, 2))
        dv[:, sl] = _mm(kc * Q, D) + _mm(Sc.transpose(1, 2), dyc)
        D = _fma(F[..., None], D, _mm((rc * P).transpose(1, 2), dyc))
        # dr and the first part of dw, forward over the chunk
        G = torch.zeros((bh, C, K), dtype=dt)
        cc = torch.zeros((bh, K), dtype=dt)
        dwa = []
        for i in range(C):
            b2 = H[:, i, i, None]
            dr[:, c * C + i] = P[:, i] * M2[:, i] + G[:, i] + \
                b2 * (ur * kc[:, i])
            d = torch.zeros((bh, K), dtype=dt)
            for t in range(C - 1, i, -1):
                d = _fma(wc[:, t], d, rc[:, t] * G[:, t])
            dwa.append(_fma(Q[:, i], _fma(P[:, i], g, cc), d))
            du_rows = du_rows + b2 * (rc[:, i] * kc[:, i])
            for t in range(i + 1, C):
                G[:, t] = _fma(wc[:, i], G[:, t], kc[:, i] * H[:, t, i, None])
            cc = _fma(wc[:, i], cc, kc[:, i] * M1[:, i])
        # dk and the rest of dw, backward over the chunk
        L = torch.zeros((bh, C, K), dtype=dt)
        e = torch.zeros((bh, K), dtype=dt)
        for i in range(C - 1, -1, -1):
            dk[:, c * C + i] = Q[:, i] * M1[:, i] + L[:, i] + \
                H[:, i, i, None] * (ur * rc[:, i])
            dw[:, c * C + i] = dwa[i] + P[:, i] * e
            for s in range(i):
                L[:, s] = _fma(wc[:, i], L[:, s], rc[:, i] * H[:, i, s, None])
            e = _fma(wc[:, i], e, rc[:, i] * M2[:, i])
    if u.shape[0] == bh:
        du = du_rows
    else:
        du = du_rows[:u.shape[0]].clone()
        for b0 in range(u.shape[0], bh, u.shape[0]):
            du = du + du_rows[b0:b0 + u.shape[0]]
    return (dr[:, :T], dk[:, :T], dv[:, :T], dw[:, :T], du, D)


# ------------------------------------------------------------- route rule


@pytest.mark.parametrize("dtype, bh, T, K, V, want", [
    # the RWKV-6 3B family sweeps' training shape, and the kernel case's
    (F32, 160, 32, 64, 64, "tf32x3"),
    (F32, 1280, 128, 64, 64, "tf32x3"),
    # ragged: T not a multiple of 16, K and V not multiples of 4, one
    # token, no token, one row
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
def test_scan_bwd_route_rule(dtype, bh, T, K, V, want):
    from repro_torch.kernels import rwkv6_scan as RS
    if isinstance(want, str):
        assert RS.scan_bwd_route(dtype, bh, T, K, V) == want
        assert want in RS.SCAN_BWD_ROUTES
    else:
        with pytest.raises(want):
            RS.scan_bwd_route(dtype, bh, T, K, V)


def test_scan_bwd_routes_are_counted():
    """Both routes have a count beside the kernel's launch count, reset
    with it; the library's entry takes the route's code, and each route's
    scratch holds one state per its interval of tokens."""
    from repro_torch.kernels import build, rwkv6_scan as RS
    assert RS.SCAN_BWD_ROUTES == {"serial": 0, "tf32x3": 1}
    assert RS.BWD_CHUNK == {"serial": 8, "tf32x3": C}
    names = {"rwkv6_scan_bwd:serial", "rwkv6_scan_bwd:tf32x3"}
    assert names <= set(build.route_counts)
    build.count_launch("rwkv6_scan_bwd", "tf32x3")
    assert build.launch_counts["rwkv6_scan_bwd"] >= 1
    assert build.route_counts["rwkv6_scan_bwd:tf32x3"] >= 1
    build.reset_launch_counts()
    assert all(build.route_counts[n] == 0 for n in names)
    assert build.launch_counts["rwkv6_scan_bwd"] == 0


def test_cuda_wrapper_refuses_before_any_route():
    """A CPU tensor, a bfloat16 one or a width no route takes is refused
    before a launch is counted on either route."""
    from repro_torch.kernels import build, rwkv6_scan as RS
    args = list(map(_t, _inputs(6, 2, 8, 4, 4)))
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        RS.rwkv6_scan_bwd(*args)
    with pytest.raises(TypeError, match="float32"):
        RS.rwkv6_scan_bwd(*(a.to(torch.bfloat16) for a in args))
    wide = list(map(_t, _inputs(6, 2, 8, 65, 4)))
    with pytest.raises(ValueError):
        RS.rwkv6_scan_bwd(*wide)
    assert build.launch_counts["rwkv6_scan_bwd"] == 0
    assert build.route_counts["rwkv6_scan_bwd:tf32x3"] == 0
    assert build.route_counts["rwkv6_scan_bwd:serial"] == 0


# ------------------------------------------------ the route's arithmetic


CASES = [
    # (T, K, V, heads, shared_state, with_ds_end)
    (32, 16, 8, 0, False, True),
    (17, 8, 8, 0, False, True),         # ragged T
    (40, 8, 16, 3, False, True),        # an (H, K) table
    (23, 5, 7, 2, True, False),         # stride-0 state, no ds_end
    (48, 64, 64, 0, True, False),       # the path's widths
    (1, 4, 4, 0, False, True),
]


@pytest.mark.parametrize("T, K, V, heads, shared, with_ds_end", CASES)
def test_emulation_float64_matches_the_plain_backward(T, K, V, heads, shared,
                                                      with_ds_end):
    from repro_torch.kernels import ref
    bh = 6
    r, k, v, w, u, s0, dy, ds_end = map(_t, _inputs(
        1, bh, T, K, V, heads=heads, dtype=np.float64))
    if shared:
        s0 = torch.zeros((1, K, V), dtype=torch.float64).expand(bh, K, V)
    dse = ds_end if with_ds_end else None
    got = _tf32x3_bwd(r, k, v, w, u, s0, dy, dse)
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, dse)
    for name, g, w_ in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name,
                                   **F64_TOL)


@pytest.mark.parametrize("T, chunk, with_ds_end", [(32, 8, True),
                                                   (64, 32, True),
                                                   (48, 16, False)])
def test_emulation_float32_matches_jax_grad_of_linattn_chunked(T, chunk,
                                                               with_ds_end):
    """The reference differentiates its jnp ``linattn_chunked`` with an
    (H, K) bonus table over (B, H, ...) rows: the route's arithmetic in
    float32 gives its gradients within the scan tolerance, and its error
    against the float64 plain backward stays within 4x the float32 plain
    backward's, the contract the card holds the route to."""
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
    cot = heads4(ds_end) if with_ds_end else jnp.zeros_like(heads4(ds_end))
    want = [np.asarray(g) for g in vjp((heads4(dy), cot))]
    args = list(map(_t, (r, k, v, w, u, s0, dy)))
    dse = _t(ds_end) if with_ds_end else None
    got = _tf32x3_bwd(*args, dse)
    for name, g, w_ in zip(NAMES, got, want):
        assert g.dtype == F32, name
        np.testing.assert_allclose(g.numpy(), w_.reshape(g.shape),
                                   err_msg=name, **SCAN_TOL)
    exact = ref.rwkv6_scan_bwd_ref(*(a.double() for a in args),
                                   None if dse is None else dse.double())
    plain = ref.rwkv6_scan_bwd_ref(*args, dse)
    for name, g, p, e in zip(NAMES, got, plain, exact):
        g_err = float((g.double() - e).abs().max())
        p_err = float((p.double() - e).abs().max())
        assert g_err <= ERR_RATIO * p_err, (name, g_err, p_err)


def test_emulation_is_finite_under_strong_decay():
    """Decays down to 2e-9: the reference's chunked form divides by their
    in-chunk products and is not finite; the route's arithmetic never
    divides, so its gradients are finite and agree with the float64 plain
    backward within 1e-5 of each gradient's scale, and within 4x the
    float32 plain backward's error."""
    from repro_torch.kernels import ref
    args = list(map(_t, _inputs(4, 4, 64, 64, 64, strong=True)))
    y, _ = ref.rwkv6_scan_ref(*args[:6], chunk=32)
    assert not torch.isfinite(y).all()
    got = _tf32x3_bwd(*args)
    exact = ref.rwkv6_scan_bwd_ref(*(a.double() for a in args))
    plain = ref.rwkv6_scan_bwd_ref(*args)
    for name, g, p, e in zip(NAMES, got, plain, exact):
        assert torch.isfinite(g).all(), name
        g_err = float((g.double() - e).abs().max())
        assert g_err <= 1e-5 * float(e.abs().max()), name
        assert g_err <= ERR_RATIO * float((p.double() - e).abs().max()), name


@pytest.mark.parametrize("decay", ["reference", "strong", "edges"])
def test_every_decay_factor_is_at_most_one(decay):
    """Every decay factor the route forms — the prefix and suffix products
    P and Q, the chunk's product F, the anchored products P' and Q', each
    score's running product — lies in
    [0, 1] for w in [0, 1], exact zeros and ones included; the gradients
    stay finite."""
    r, k, v, w, u, s0, dy, ds_end = _inputs(11, 4, 40, 16, 8,
                                            strong=decay == "strong")
    if decay == "edges":
        w = np.where(np.random.default_rng(12).random(w.shape) < 0.3,
                     np.float32(0.0), np.float32(1.0))
    factors = []
    got = _tf32x3_bwd(*map(_t, (r, k, v, w, u, s0, dy, ds_end)),
                      factors=factors)
    assert factors
    for f in factors:
        assert bool((f <= 1.0).all()) and bool((f >= 0.0).all())
    for name, g in zip(NAMES, got):
        assert bool(torch.isfinite(g).all()), name
