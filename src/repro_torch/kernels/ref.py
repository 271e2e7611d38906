"""Plain PyTorch versions of every kernel in this package.

Used by tensors that lie on the CPU, by the tests, and as the yardstick the
CUDA kernels are held against on the card.  Never used for a CUDA tensor on
the package's own paths.

**Derivatives at ties follow JAX, not PyTorch.**  The reference trains by
``jax.grad``, and SNL's mask weights sit on the bounds of their clip at
almost every step, so the port takes every derivative at a tie as JAX does:

  * ``max(x, 0)`` (relu, and the ``r`` of sqrelu): 1/2 at x = 0 —
    ``torch.relu`` gives 0 and ``torch.clamp_min`` 1.  sqrelu = r·r is then
    0 at 0 all the same.
  * ``clip(x, lo, hi)``: 1/2 at x = lo and at x = hi (``jnp.clip`` is
    ``minimum(maximum(x, lo), hi)``) — ``torch.clamp`` gives 1.
  * ``|x|``: 1 at x = 0 (and at -0) — ``torch.abs`` gives 0.
  * tanh-GELU and SiLU: the derivative of the very expressions
    :func:`_act` evaluates.

:func:`tie_clamp`, :func:`abs_tie` and :func:`_act` (when a gradient is
being recorded) carry these conventions into autograd;
:func:`masked_act_bwd_ref` writes the hard gate's gradient out with them,
and the CUDA backward (``csrc/masked_act.cu`` ``gate_bwd_kernel``)
computes the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class _TieClamp(torch.autograd.Function):
    """``clamp(x, lo, hi)`` (``hi`` may be None) whose derivative is 1
    inside, 1/2 on a bound and 0 outside."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        inside = x > lo
        tie = x == lo
        if hi is not None:
            inside = inside & (x < hi)
            tie = tie | (x == hi)
        return g * (inside.to(g.dtype) + 0.5 * tie.to(g.dtype)), None, None


def recording(*tensors) -> bool:
    """Is autograd recording, and does one of ``tensors`` (None is
    skipped) require a gradient?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def tie_clamp(x: torch.Tensor, lo: float, hi=None) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` with JAX's derivative at the bounds (1/2);
    plain ``torch.clamp`` when no gradient is being recorded."""
    if recording(x):
        return _TieClamp.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


def abs_tie(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative is 1 at 0, as ``jax.grad(jnp.abs)`` is."""
    return torch.where(x >= 0, x, -x)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return tie_clamp(x, 0.0)
    if kind == "gelu":
        # tanh approximation — what the kernel computes
        return 0.5 * x * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))
    if kind == "silu":
        return x * (1.0 / (1.0 + torch.exp(-x)))
    if kind == "sqrelu":
        r = tie_clamp(x, 0.0)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def act_grad_ref(x: torch.Tensor, kind: str) -> torch.Tensor:
    """d act / dx, written out with the conventions above; what the CUDA
    backward computes element by element."""
    if kind == "relu":
        return (x > 0).to(x.dtype) + 0.5 * (x == 0).to(x.dtype)
    if kind == "gelu":
        x2 = x * x
        t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x2 * x)))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * \
            (_SQRT_2_OVER_PI * (1.0 + 0.134145 * x2))
    if kind == "silu":
        # d/dx of x * (1 / u), u = 1 + exp(-x), as autodiff takes it
        e = torch.exp(-x)
        u = 1.0 + e
        return 1.0 / u + x * (e / (u * u))
    if kind == "sqrelu":
        return torch.where(x > 0, 2.0 * x, torch.zeros_like(x))
    raise ValueError(f"unknown activation {kind!r}")


def masked_act_ref(x, mask, kind: str = "relu", poly=None):
    """y = mask * act(x) + (1-mask) * g(x).

    x:    (..., C) activations
    mask: broadcastable against x — (C,) per-channel, or a full site shape,
          or (N, 1, ..., C) for stacked candidates
    poly: None -> g(x) = x; (3, C...) -> g(x) = a*x^2 + b*x + c
    """
    act = _act(x, kind)
    if poly is None:
        lin = x
    else:
        a, b, c = poly[0].to(x.dtype), poly[1].to(x.dtype), \
            poly[2].to(x.dtype)
        lin = a * x * x + b * x + c
    m = mask.to(x.dtype)
    return m * act + (1.0 - m) * lin


def masked_act_bwd_ref(x, mask, g, kind: str = "relu", poly=None,
                       need_dpoly: bool = False):
    """The hard gate's gradient, the plain version of the CUDA backward.

    x, g: (rows, C) float32; mask: (C,); poly: None or (3, C).  Returns
    ``(dx, dpoly)``:

      dx    = (g·m)·act'(x) + (g·(1−m))·lin'(x),  lin' = 1 or 2a·x + b
      dpoly = Σ_rows (g·(1−m))·(x², x, 1)         (None unless need_dpoly)

    with the derivative conventions of this module's docstring.
    """
    m = mask.to(x.dtype)
    gm = g * m
    g1m = g * (1.0 - m)
    if poly is None:
        dlin = g1m
    else:
        dlin = g1m * (2.0 * poly[0] * x + poly[1])
    dx = gm * act_grad_ref(x, kind) + dlin
    dpoly = None
    if need_dpoly:
        gx = g1m * x
        dpoly = torch.stack([(gx * x).sum(0), gx.sum(0), g1m.sum(0)])
    return dx, dpoly


def masked_act_matmul_ref(x, mask, w, mul=None, *, kind: str = "relu"):
    """The unfused pair of the fused gate→matmul kernel:
    ``masked_act_ref(x, mask) [· mul] @ w`` (identity replacement only).

    x: (..., K); mask: (K,); w: (K, N_out) shared; mul: optional (..., K),
    the gated FFN's up branch, multiplied after the gate and before the
    product.
    """
    g = masked_act_ref(x, mask, kind=kind)
    if mul is not None:
        g = g * mul
    return g @ w


def masked_act_matmul_batched_ref(x, masks, w, mul=None, *,
                                  kind: str = "relu"):
    """Stacked-candidate :func:`masked_act_matmul_ref`: masks (N, K), one row
    per candidate; x and mul (N, ..., K), where a candidate axis of stride 0
    (an ``expand``-ed shared activation) broadcasts as it stands."""
    n = masks.shape[0]
    m = masks.reshape((n,) + (1,) * (x.dim() - 2) + (masks.shape[-1],))
    return masked_act_matmul_ref(x, m, w, mul, kind=kind)


def same_pads(size: int, stride: int, window: int = 3):
    """XLA SAME-padding geometry for one spatial dim: (out, lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    lo = total // 2
    return out, lo, total - lo


def conv_same_nhwc(x, w, stride: int = 1):
    """SAME convolution, x (B, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO.

    The NHWC tensor viewed as NCHW is exactly ``channels_last``, which
    ``F.conv2d`` takes without a copy.  SAME pads follow XLA: at stride 2 on
    an even size a 3-tap window pads (0, 1), which ``padding=1`` would get
    wrong.
    """
    kh, kw = w.shape[0], w.shape[1]
    _, hlo, hhi = same_pads(x.shape[1], stride, kh)
    _, wlo, whi = same_pads(x.shape[2], stride, kw)
    xn = x.permute(0, 3, 1, 2)
    if not x.is_cuda and recording(x, w):
        # PyTorch's CPU (oneDNN) backward of a strided convolution of a
        # channels_last input corrupts the heap (seen with torch 2.13 at a
        # 1x1 stride-2 convolution of 32x32 images); a CPU training
        # forward hands it contiguous NCHW.  The card and every
        # forward without a gradient take the view as it is.
        xn = xn.contiguous()
    if hlo == hhi and wlo == whi:
        padding = (hlo, wlo)
    else:
        xn = F.pad(xn, (wlo, whi, hlo, hhi))
        padding = 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero — the card's ``cvt.rna.tf32.f32`` — on the int32 view: add
    half of the 13 dropped bits, then clear them.  Exact for finite values
    and infinities (a value above the largest TF32 goes to infinity)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The big and small TF32 parts of a float32 tensor: hi = tf32(x) and
    lo = tf32(x - hi), where x - hi is exact in float32; hi + lo keeps
    about 22 significant bits of x."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def masked_act_conv3x3_tf32x3_ref(x, mask, w, *, stride: int = 1,
                                  kind: str = "relu"):
    """A plain emulation of the fused conv's route T (``"tf32x3"``) for the
    tests: output pixel by output pixel, the in-image taps only, each gated
    operand and weight split into TF32 parts and every product taken as
    hi·W_hi + hi·W_lo + lo·W_hi with float32 sums — the arithmetic of the
    tensor-core kernel, in another order.  Shapes as
    :func:`masked_act_conv3x3_ref`; float32 only.  The port's ``ops`` never
    call it: a CPU tensor takes :func:`masked_act_conv3x3_ref`."""
    m = mask.to(torch.float32)
    if m.dim() == 4:
        m = m[:, None]
    x = x.to(torch.float32)
    g_hi, g_lo = split_tf32(m * _act(x, kind) + (1.0 - m) * x)
    w_hi, w_lo = split_tf32(w)
    h, wd = g_hi.shape[-3], g_hi.shape[-2]
    ho, ph, _ = same_pads(h, stride)
    wo, pw, _ = same_pads(wd, stride)
    out = g_hi.new_zeros(g_hi.shape[:-3] + (ho, wo, w.shape[-1]))
    for oy in range(ho):
        for ox in range(wo):
            acc = out[..., oy, ox, :]
            for ky in range(3):
                iy = oy * stride - ph + ky
                for kx in range(3):
                    ix = ox * stride - pw + kx
                    if not (0 <= iy < h and 0 <= ix < wd):
                        continue
                    a_hi, a_lo = g_hi[..., iy, ix, :], g_lo[..., iy, ix, :]
                    acc += a_hi @ w_lo[ky, kx]
                    acc += a_lo @ w_hi[ky, kx]
                    acc += a_hi @ w_hi[ky, kx]
    return out


def linattn_chunked_ref(r, k, v, w, u, s0, *, chunk: int,
                        decay_first: bool = False):
    """Chunked decayed linear attention over any leading axes: the
    arithmetic of the TPU scan kernel (``rwkv6_scan.py:42-62``) and of the
    reference's ``ssm.linattn_chunked``.

    decay_first=False (RWKV):  y_t = r_t·S_{t-1} + (r_t·(u⊙k_t))·v_t,
                               S_t = diag(w_t)·S_{t-1} + k_tᵀv_t
    decay_first=True (SSD):    S_t as above, y_t = r_t·S_t (u unused)

    r, k, w: (..., T, K); v: (..., T, V); u: broadcastable against
    (..., K), or None; s0: (..., K, V).  Within a chunk, with the inclusive
    decay product P_t, y = tril(R'K'ᵀ + diag(bonus))·V + R'·S₀ with
    R' = r⊙P/w (r⊙P for SSD), K' = k/P; the state is carried from chunk to
    chunk in float32.  Returns y (..., T, V) in r's dtype and the final
    state.  T must be a multiple of ``chunk``.
    """
    T = r.shape[-2]
    if chunk < 1 or T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"scan chunk {chunk}")
    n, dev = T // chunk, r.device
    ti = torch.arange(chunk, device=dev)[:, None]
    si = torch.arange(chunk, device=dev)[None, :]
    tri = (si <= ti) if decay_first else (si < ti)
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    S = s0.to(torch.float32)
    ys = []
    for j in range(n):
        sl = slice(j * chunk, (j + 1) * chunk)
        rj, kj, vj, wj = (t[..., sl, :] for t in (r, k, v, w))
        p_incl = torch.cumprod(wj, dim=-2)
        r_p = rj * (p_incl if decay_first else p_incl / wj)
        k_p = kj / p_incl
        scores = torch.where(tri, r_p @ k_p.transpose(-1, -2), 0.0)
        if u is not None and not decay_first:
            bonus = (rj * u[..., None, :] * kj).sum(-1)
            scores = scores + bonus[..., None] * eye
        ys.append(scores @ vj + r_p @ S)
        p_end = p_incl[..., -1, :]
        k_end = kj * (p_end[..., None, :] / p_incl)
        S = p_end[..., None] * S + k_end.transpose(-1, -2) @ vj
    return torch.cat(ys, dim=-2).to(r.dtype), S


def _rwkv6_u_rows(u, bh: int):
    """u as one row per (batch·head) row: ``(BH, K)`` as it is, or an
    ``(H, K)`` per-head table with BH a multiple of H (row bh reads
    ``u[bh % H]``, the fold of B·H heads)."""
    if u.dim() != 2 or u.shape[0] < 1 or bh % u.shape[0]:
        raise ValueError(f"u must be ({bh}, K) or (H, K) with H dividing "
                         f"{bh}, got {tuple(u.shape)}")
    return u.repeat(bh // u.shape[0], 1) if u.shape[0] != bh else u


def rwkv6_scan_ref(r, k, v, w, u, state, *, chunk: int = 32):
    """The plain version of the RWKV-6 scan kernel: the TPU kernel's
    chunked arithmetic, vectorised over BH.

    r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K) or an (H, K) table
    (:func:`_rwkv6_u_rows`); state: (BH, K, V).  Returns y (BH, T, V) and
    the new state (BH, K, V), float32.  T must be a multiple of ``chunk``.
    """
    return linattn_chunked_ref(r, k, v, w, _rwkv6_u_rows(u, r.shape[0]),
                               state, chunk=chunk)


def rwkv6_serial_ref(r, k, v, w, u, state):
    """The token-serial RWKV-6 recurrence (the reference's oracles
    ``ops._rwkv6_scan_jnp`` and ``ref.rwkv6_chunk_ref``), in the inputs'
    own dtype: ``chip_smoke.py`` runs it in float64 as the yardstick of
    both the kernel and the chunked plain version.  Shapes as
    :func:`rwkv6_scan_ref`."""
    u = _rwkv6_u_rows(u, r.shape[0])
    S = state.clone()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        y = (rt[:, None, :] @ S)[:, 0] + \
            (rt * (u * kt)).sum(-1, keepdim=True) * vt
        S = wt[..., None] * S + kt[..., None] * vt[:, None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), S


def rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_end=None):
    """The plain version of the scan's backward (``csrc/rwkv6_scan_bwd.cu``,
    which the reference has no counterpart of: it differentiates its jnp
    scan).  The exact recurrence, walked backward with dS carried::

      dS_{t-1} = diag(w_t) dS_t + r_tᵀ dy_t
      dr_t = dy_t S_{t-1}ᵀ + (dy_t·v_t)(u⊙k_t)
      dk_t = dS_t v_tᵀ + (dy_t·v_t)(u⊙r_t)
      dv_t = k_t dS_t + (r_t·(u⊙k_t)) dy_t
      dw_t = Σ_v dS_t ⊙ S_{t-1}
      du  += (dy_t·v_t)(r_t⊙k_t)

    with each S_{t-1} saved on the way forward, never recovered by dividing
    by a decay.  Shapes as :func:`rwkv6_scan_ref`, plus dy (BH, T, V) and
    ``ds_end`` (BH, K, V) or None (no gradient reaches the final state).
    Returns ``(dr, dk, dv, dw, du, ds0)`` in the inputs' dtype: du in u's
    own shape — an (H, K) table's rows summed over the rows bh of each head
    h = bh % H, in increasing bh — and ds0 (BH, K, V)."""
    bh, T, K = r.shape
    V = v.shape[-1]
    ur = _rwkv6_u_rows(u, bh)
    S = state.expand(bh, K, V)
    prev = []                      # S_{t-1} for every t
    for t in range(T):
        prev.append(S)
        S = w[:, t, :, None] * S + k[:, t, :, None] * v[:, t, None, :]
    dS = torch.zeros((bh, K, V), dtype=r.dtype, device=r.device) \
        if ds_end is None else ds_end.expand(bh, K, V).clone()
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    du_rows = torch.zeros((bh, K), dtype=r.dtype, device=r.device)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
        sp = prev[t]
        dyv = (dyt * vt).sum(-1, keepdim=True)
        uk = ur * kt
        b = (rt * uk).sum(-1, keepdim=True)
        dr[:, t] = (sp @ dyt[..., None])[..., 0] + dyv * uk
        dk[:, t] = (dS @ vt[..., None])[..., 0] + dyv * (ur * rt)
        dv[:, t] = (kt[:, None, :] @ dS)[:, 0] + b * dyt
        dw[:, t] = (dS * sp).sum(-1)
        du_rows = du_rows + dyv * (rt * kt)
        dS = wt[..., None] * dS + rt[..., None] * dyt[:, None, :]
    if u.shape[0] == bh:
        du = du_rows
    else:
        du = du_rows[:u.shape[0]].clone()
        for b0 in range(u.shape[0], bh, u.shape[0]):
            du = du + du_rows[b0:b0 + u.shape[0]]
    return dr, dk, dv, dw, du, dS


# route C's chunk (``csrc/rwkv6_scan_sm90.cu`` kC): two sub-blocks of 8
SCAN_TF32X3_CHUNK = 16
_SCAN_SUB = 8
_SCAN_PAD = 64          # route C pads K and V to 64


def _tf32x3_steps(a, b, depth: int = 8):
    """``a @ b`` as route C's tensor cores take it: the contracted axis in
    steps of ``depth``, each operand of a step split into TF32 parts and the
    step taken as hi·lo + lo·hi + hi·hi, each step a fresh sum added to the
    float32 total."""
    out = None
    for j in range(0, a.shape[-1], depth):
        a_hi, a_lo = split_tf32(a[..., j:j + depth])
        b_hi, b_lo = split_tf32(b[..., j:j + depth, :])
        p = a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi
        out = p if out is None else out + p
    return out


def rwkv6_scan_tf32x3_ref(r, k, v, w, u, state, *, chunk: int = 32,
                          factors: list = None):
    """A plain emulation of the scan's route C (``"tf32x3"``) for the tests:
    its chunk of 16 tokens in two sub-blocks of 8, its decay factors — every
    one a running product of w over a forward interval, never divided by —
    its anchors, and its products with every operand split by
    :func:`split_tf32` and summed in steps of 8 (32 for r·S) deep
    (:func:`_tf32x3_steps`).
    Per chunk, with P_t the product of w from t's sub-block start to t − 1,
    Q_s the one from s + 1 to s's sub-block end, F0 and F1 the sub-blocks'
    whole products:

      R~ = r·P (·F0 in sub-block 1)      K~ = k·Q (·F1 in sub-block 0)
      y  = A·V + R~·S, A the in-chunk scores: the bonus r·(u⊙k) on the
           diagonal, pairs inside a sub-block weighted by running products,
           sub-block 1's targets against sub-block 0's sources as
           (r·P)(k·Q)ᵀ (anchored at their boundary)
      S  = diag(F0·F1)·S + K~ᵀ·V         (a fused multiply-add)

    in the kernel's order of float32 sums, the products' own sums in
    another.  Shapes and arguments as :func:`rwkv6_scan_ref` (T a multiple
    of ``chunk``, which the kernel does not use); float32.  ``factors``, if
    a list, receives every decay factor formed.  The port's ``ops`` never
    call it: a CPU tensor takes :func:`rwkv6_scan_ref`."""
    bh, T, K = r.shape
    V = v.shape[-1]
    if chunk < 1 or T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"scan chunk {chunk}")
    C, H, W = SCAN_TF32X3_CHUNK, _SCAN_SUB, _SCAN_PAD
    n = -(-T // C)
    f32 = torch.float32

    def pad(t, width, fill=0.0):
        out = torch.full((bh, n * C, width), fill, dtype=f32)
        out[:, :T, :t.shape[-1]] = t.to(f32)
        return out
    rp, kp, vp = pad(r, W), pad(k, W), pad(v, W)
    # a padded token decays nothing; padded columns of k and r are zero
    wp = pad(w, W, 1.0)
    up = torch.zeros((bh, W), dtype=f32)
    up[:, :K] = _rwkv6_u_rows(u, bh).to(f32)
    S = torch.zeros((bh, W, W), dtype=f32)
    S[:, :K, :V] = state.to(f32)
    record = factors.append if factors is not None else (lambda x: None)
    ys = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, wc = rp[:, sl], kp[:, sl], vp[:, sl], wp[:, sl]
        P, Q = torch.ones_like(wc), torch.ones_like(wc)
        for b0 in (0, H):
            for i in range(1, H):
                P[:, b0 + i] = P[:, b0 + i - 1] * wc[:, b0 + i - 1]
            for i in range(H - 2, -1, -1):
                Q[:, b0 + i] = Q[:, b0 + i + 1] * wc[:, b0 + i + 1]
        F0 = P[:, H - 1] * wc[:, H - 1]
        F1 = P[:, C - 1] * wc[:, C - 1]
        rf = torch.cat([P[:, :H], P[:, H:] * F0[:, None]], 1)
        kf = torch.cat([Q[:, :H] * F1[:, None], Q[:, H:]], 1)
        decay = F0 * F1
        for x in (P, Q, F0, F1, rf, kf, decay):
            record(x)
        r_t, k_t = rc * rf, kc * kf
        A = torch.zeros((bh, C, C), dtype=f32)
        for b0 in (0, H):
            for s in range(H):
                E = kc[:, b0 + s]
                D = torch.ones_like(E)
                for t in range(s + 1, H):
                    A[:, b0 + t, b0 + s] = (rc[:, b0 + t] * E).sum(-1)
                    record(D)
                    E = E * wc[:, b0 + t]
                    D = D * wc[:, b0 + t]
        idx = torch.arange(C)
        A[:, idx, idx] = (rc * (up[:, None, :] * kc)).sum(-1)
        # sub-block 1's targets against sub-block 0's sources, anchored at
        # their boundary: four partial sums of two 8-deep steps each (the
        # kernel's four warps), added in order
        ra, kb = rc[:, H:] * P[:, H:], (kc[:, :H] * Q[:, :H]).transpose(1, 2)
        cross = None
        for j in range(0, W, 16):
            x = _tf32x3_steps(ra[..., j:j + 16], kb[:, j:j + 16])
            cross = x if cross is None else cross + x
        A[:, H:, :H] = cross
        # the in-chunk steps first, then the state's in steps of 32 k, one
        # running sum
        y = _tf32x3_steps(A, vc)
        for j in range(0, W, 32):
            y = y + _tf32x3_steps(r_t[..., j:j + 32], S[:, j:j + 32], 32)
        ys.append(y)
        p = _tf32x3_steps(k_t.transpose(1, 2), vc)
        # the kernel's fused multiply-add, rounded once
        S = (decay[:, :, None].double() * S.double() + p.double()).to(f32)
    y = torch.cat(ys, 1)[:, :T, :V] if ys else torch.zeros((bh, 0, V))
    return y.contiguous(), S[:, :K, :V].contiguous()


def masked_act_conv3x3_ref(x, mask, w, *, stride: int = 1,
                           kind: str = "relu"):
    """The unfused pair: full-site gate, then the SAME 3x3 convolution.

    x: (B, H, W, Cin) or stacked (N, B, H, W, Cin); mask: (H, W, Cin) or
    stacked (N, H, W, Cin) (either side may be un-stacked: it is shared by
    the candidates); w: (3, 3, Cin, Cout).
    """
    m = mask.to(x.dtype)
    if m.dim() == 4:
        m = m[:, None]
    g = m * _act(x, kind) + (1.0 - m) * x
    lead = g.shape[:-3]
    y = conv_same_nhwc(g.reshape((-1,) + g.shape[-3:]), w, stride)
    return y.reshape(lead + y.shape[1:])
