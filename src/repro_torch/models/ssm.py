"""Recurrent blocks: Mamba2 (SSD) and RWKV-6 (Finch), eval path, prefill
and decode.

Counterpart of ``repro/models/ssm.py``: the shared chunked linear attention
and the single-token decode step (``linattn_step``), the Mamba2 block and
the RWKV-6 time- and channel-mix.

The reference's time-mix calls its jnp ``linattn_chunked``, whose
arithmetic is that of its TPU scan kernel: here the time-mix calls
``kernels.ops.rwkv6``, which is the hand-written CUDA kernel for a CUDA
tensor and the chunked plain version for a CPU one, on ``(lead·B·H, S, hd)``
views, where ``lead`` is the candidate axis of a stacked activation.  The
Mamba2 scan (``decay_first=True``) is jnp code in the reference, not a TPU
kernel, and runs here as the plain chunked version
(:func:`linattn_chunked`).  A decode step (one token, with a cache) takes
the exact O(1) recurrence ``linattn_step`` in plain PyTorch, as the
reference computes it in jnp outside any kernel.

State locality: the recurrent state (the scan's state, the token shift's
left neighbour, the causal convolution's trailing inputs) lives within one
block application.  Without a cache it starts from zeros, so nothing
recurrent crosses stack repeats, a cut between repeats is a plain
checkpoint of the (…, B, S, D) residual stream and ``prefix ∘ suffix ==
forward`` holds as for dense blocks.  With a cache (serving) it starts from
the cache and the new state is written back into it, block by block.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import linearize, spmd
from repro_torch.kernels import ops, ref
from . import layers


def linattn_chunked(r, k, v, w, u, s0, *, chunk: int, decay_first=False):
    """Generalized decayed linear attention, chunked (the reference's
    ``linattn_chunked``, plain PyTorch).

    decay_first=False (RWKV convention):
      y_t = r_t·S_{t-1} + (r·(u⊙k))·v_t ;  S_t = diag(w_t)·S_{t-1} + k_tᵀv_t
    decay_first=True (Mamba2/SSD convention):
      S_t = diag(w_t)·S_{t-1} + k_tᵀv_t ;  y_t = r_t·S_t     (u ignored)
    r,k,w: (B,H,T,K)  v: (B,H,T,Vd)  u: (H,K) or None  s0: (B,H,K,Vd).
    Returns y (B,H,T,Vd), S_end.  T % chunk == 0.
    """
    return ref.linattn_chunked_ref(r, k, v, w, u, s0, chunk=chunk,
                                   decay_first=decay_first)


def linattn_step(r, k, v, w, u, S, decay_first=False):
    """Single-token decode, the exact recurrence (the reference's
    ``linattn_step``): r, k, w (B, H, K), v (B, H, Vd), S (B, H, K, Vd),
    u (H, K) or None.  Returns y (B, H, Vd) and the new state."""
    if decay_first:
        S = w[..., None] * S + k[..., None] * v[..., None, :]
        return torch.einsum("bhk,bhkv->bhv", r, S), S
    y = torch.einsum("bhk,bhkv->bhv", r, S)
    if u is not None:
        y = y + torch.einsum("bhk,hk,bhk->bh", r, u, k)[..., None] * v
    S = w[..., None] * S + k[..., None] * v[..., None, :]
    return y, S


# ================================================================= Mamba2


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    d_inner: int        # typically 2·d_model
    n_heads: int        # d_inner / head_dim
    head_dim: int = 64
    d_state: int = 64
    d_conv: int = 4
    chunk: int = 64


def mamba_init(gen: torch.Generator, c: MambaCfg, dtype=torch.bfloat16,
               device="cuda"):
    """Random parameters drawn from ``gen``: the reference's tree (keys,
    shapes, dtypes; ``dt_bias``, ``A_log`` and ``D`` stay float32), not its
    numbers.  ``A_log`` starts at -4, decays of about 0.99 a token, as the
    reference's: the chunked scan divides by in-chunk decay products, which
    a stronger decay would underflow within a 64-token chunk."""
    d, di, nh, N = c.d_model, c.d_inner, c.n_heads, c.d_state
    s = d ** -0.5

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return {
        "w_z": layers.normal(gen, (d, di), s, dtype, device),
        "w_x": layers.normal(gen, (d, di), s, dtype, device),
        "conv": layers.normal(gen, (c.d_conv, di), 0.1, dtype, device),
        "w_bcdt": layers.normal(gen, (d, 2 * N + nh), s, dtype, device),
        "dt_bias": full((nh,), 0.0),
        "A_log": full((nh,), -4.0),
        "D": full((nh,), 1.0),
        "w_out": layers.normal(gen, (di, d), di ** -0.5, dtype, device),
    }


def _causal_conv(xin, conv, state=None):
    """Depthwise causal convolution along the sequence.  xin: (G, S, di);
    conv: (dc, di); state: (G, dc-1, di), the trailing inputs of earlier
    steps (decode), or None for zeros.  Returns the output and the new
    state, the last dc-1 inputs."""
    dc = conv.shape[0]
    if state is None:
        pad = torch.zeros_like(xin[:, :dc - 1])
    else:
        pad = state.to(xin.dtype)
    xp = torch.cat([pad, xin], dim=1)
    S = xin.shape[1]
    out = xp[:, 0:S] * conv[0]
    for i in range(1, dc):           # in the reference's order
        out = out + xp[:, i:i + S] * conv[i]
    return out, xp[:, -(dc - 1):]


def mamba_block(p, c: MambaCfg, x, mask, site: linearize.MaskSite, *,
                poly=None, soft=False, ties=True, cache=None, tp=None):
    """The Mamba2 block of (…, B, S, d) activations, its mask site the silu
    gate on z, of shape (d_inner,).  The scan runs on G = (product of the
    leading axes) rows at ``chunk = min(c.chunk, S)``; raises
    ``ValueError`` where S exceeds the chunk and is not a multiple of it
    (the reference's ``linattn_chunked`` needs the same).

    mask: (di,), or (N, di) stacked; a shared x under stacked masks runs
    everything before the gate once and reaches the gate as a stride-0
    candidate view.  Without a cache returns y alone.
    ``cache=(ssm_state (B, nh, N, hd) float32, conv_state (B, dc-1, di))``
    takes x (B, S, d) and returns ``(y, (ssm_state, conv_state))``, the
    scan starting from the cached state; one token takes the exact
    recurrence :func:`linattn_step` instead of the scan, as the reference
    does.

    ``tp`` (tensor parallelism over ``"model"``): ``w_z``, ``w_x`` and the
    depthwise ``conv`` hold the rank's block of d_inner / size channels,
    ``nh / size`` whole heads; ``w_bcdt`` is whole (every rank reads the
    same B, C and dt, and keeps the dt of its heads), the per-head
    ``dt_bias``, ``A_log`` and ``D`` are cut to the rank's heads, the scan
    runs on them, the gate mask is cut to the block and the cache holds
    the rank's heads and channels; ``w_out`` (``_ROW``) gives a partial
    sum, summed over the axis."""
    *lead, S, d = x.shape
    di, nh, hd, N = c.d_inner, c.n_heads, c.head_dim, c.d_state
    span = layers.tp_split(p["w_z"].shape[-1], di, tp)
    h0 = 0
    if span is not None:
        lo, hi = span
        h0, di = lo // hd, hi - lo
        nh = di // hd
        x = spmd.enter(x, tp)
        p = dict(p, w_bcdt=spmd.enter(p["w_bcdt"], tp),
                 **{k: spmd.enter(p[k], tp)[h0:h0 + nh]
                    for k in ("dt_bias", "A_log", "D")})
        mask, poly = layers.slice_site(mask, poly, span)
        site = dataclasses.replace(site, shape=(di,))
    chunk = min(c.chunk, S)
    step = S == 1 and cache is not None
    if S % chunk and not step:
        raise ValueError(
            f"mamba block: sequence length {S} is not a multiple of the scan "
            f"chunk {chunk} (min({c.chunk}, S)); the reference's "
            "linattn_chunked refuses it too")
    G = x.numel() // (S * d)
    xg = x.reshape(G, S, d)
    z = x @ p["w_z"]
    xin, conv_state = _causal_conv(xg @ p["w_x"], p["conv"],
                                   None if cache is None else cache[1])
    xin = F.silu(xin)
    bcdt = xg @ p["w_bcdt"]
    b, cc = bcdt[..., :N], bcdt[..., N:2 * N]
    dt = bcdt[..., 2 * N + h0:2 * N + h0 + nh]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])       # (G, S, nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                  # (G, S, nh)
    v = xin.reshape(G, S, nh, hd).transpose(1, 2)               # (G,nh,S,hd)
    kk = (b[..., None, :] * dt[..., None]).transpose(1, 2) \
        .to(torch.float32)                                      # (G,nh,S,N)
    rr = cc[..., None, :].expand(G, S, nh, N).transpose(1, 2) \
        .to(torch.float32)
    ww = a[..., None].expand(G, S, nh, N).transpose(1, 2)
    vf = v.to(torch.float32)
    if cache is None:
        s0 = torch.zeros((1, 1, N, hd), dtype=torch.float32,
                         device=x.device).expand(G, nh, N, hd)
    else:
        s0 = cache[0]
    if step:
        y1, s_end = linattn_step(rr[:, :, 0], kk[:, :, 0], vf[:, :, 0],
                                 ww[:, :, 0], None, s0, decay_first=True)
        y = y1[:, :, None]
    else:
        y, s_end = linattn_chunked(rr, kk, vf, ww, None, s0, chunk=chunk,
                                   decay_first=True)
    y = y + p["D"][None, :, None, None] * v.to(y.dtype)
    y = y.transpose(1, 2).reshape(*lead, S, di).to(x.dtype)
    if mask.dim() == len(site.shape) + 1 and x.dim() == 3:
        z = z.unsqueeze(0).expand((mask.shape[0],) + tuple(z.shape))
    gate = linearize.apply_masked_act(z, mask, site, poly=poly, soft=soft,
                                      ties=ties)
    out = (y * gate) @ p["w_out"]
    if span is not None:
        out = spmd.all_reduce_sum(out, tp)
    return out if cache is None else (out, (s_end, conv_state))


# ================================================================= RWKV-6


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    d_model: int
    d_ff: int
    head_dim: int = 64
    chunk: int = 32

    @property
    def n_heads(self):
        return self.d_model // self.head_dim


def rwkv_init(gen: torch.Generator, c: RWKVCfg, dtype=torch.bfloat16,
              device="cuda"):
    """Random parameters drawn from ``gen``: the reference's tree (keys,
    shapes, dtypes; the lerp weights, decay bias and bonus stay float32),
    not its numbers."""
    d, f, H, hd = c.d_model, c.d_ff, c.n_heads, c.head_dim
    s = d ** -0.5

    def proj(m, n, sc):
        return layers.normal(gen, (m, n), sc, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return {
        "mu": full((5, d), 0.5),          # token-shift lerp r, k, v, w, g
        "w_r": proj(d, d, s), "w_k": proj(d, d, s), "w_v": proj(d, d, s),
        "w_g": proj(d, d, s), "w_w": proj(d, d, s * 0.1),
        "w_bias": full((d,), -2.0),
        "u": layers.normal(gen, (H, hd), 0.3, torch.float32, device),
        "w_o": proj(d, d, s),
        "ln_x": layers.rmsnorm_init(hd, device),
        "mu_c": full((2, d), 0.5),        # channel-mix shift
        "w_ck": proj(d, f, s),
        "w_cv": proj(f, d, f ** -0.5),
        "w_cr": proj(d, d, s),
    }


def _shift(x, prev=None):
    """Token shift along the sequence axis of (…, S, D): x_{t-1}, with
    x_{-1} = ``prev`` (…, D), the cache's last token, or 0 without one."""
    first = torch.zeros_like(x[..., :1, :]) if prev is None \
        else prev[..., None, :].to(x.dtype)
    return torch.cat([first, x[..., :-1, :]], dim=-2)


def _lerp(mu, x, xs):
    # in float32 (mu is float32), cast to the stream's dtype, as the
    # reference rounds
    return (mu * x + (1 - mu) * xs).to(x.dtype)


def rwkv_time_mix(p, c: RWKVCfg, x, *, cache=None, tp=None):
    """The time-mix of (…, B, S, D) activations; the scan runs on
    ``(G·H, S, hd)`` float32 rows, G the product of the leading axes.
    Raises ``ValueError`` when S exceeds the scan chunk and is not a
    multiple of it (the reference's ``linattn_chunked`` needs the same).

    Without a cache returns y alone (the eval contract), the scan starting
    from one zero state.  ``cache=(state, prev_x)`` — state (B, H, hd, hd)
    float32, prev_x (B, D) the block input's last token — takes x (B, S, D)
    and returns ``(y, (S_end, x[:, -1]))``: the scan starts from ``state``
    and its final state is kept; one token takes the exact recurrence
    :func:`linattn_step` instead of the scan, as the reference does.

    ``tp`` (tensor parallelism over ``"model"``): the ``_COL`` projections
    ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_w`` hold the rank's block of
    ``H / size`` heads, the per-head leaves every rank holds whole (the
    bonus ``u``, the decay bias) are cut to it, the scan (kernel 7) runs on
    those heads and the state ``(B, H / size, hd, hd)`` holds them; the
    ``_ROW`` output projection ``w_o`` gives a partial sum, summed over the
    axis.  The token shift reads the whole ``d``."""
    *lead, S, d = x.shape
    H, hd = c.n_heads, c.head_dim
    span = layers.tp_split(p["w_r"].shape[-1], d, tp)
    if span is not None:
        lo, hi = span
        H = (hi - lo) // hd
        x = spmd.enter(x, tp)
        p = dict(p, mu=spmd.enter(p["mu"], tp),
                 w_bias=spmd.enter(p["w_bias"], tp)[lo:hi],
                 u=spmd.enter(p["u"], tp)[lo // hd:hi // hd],
                 ln_x={"scale": spmd.enter(p["ln_x"]["scale"], tp)})
    chunk = min(c.chunk, S)
    step = S == 1 and cache is not None
    if S % chunk and not step:
        raise ValueError(
            f"rwkv time-mix: sequence length {S} is not a multiple of the "
            f"scan chunk {chunk} (min({c.chunk}, S)); the reference's "
            "linattn_chunked refuses it too")
    G = x.numel() // (S * d)
    xs = _shift(x, None if cache is None else cache[1])

    def heads(t):          # (…, S, d) -> (G·H, S, hd), float32, contiguous
        return t.to(torch.float32).reshape(G, S, H, hd).transpose(1, 2) \
            .reshape(G * H, S, hd)
    r = heads(_lerp(p["mu"][0], x, xs) @ p["w_r"])
    k = heads(_lerp(p["mu"][1], x, xs) @ p["w_k"])
    v = heads(_lerp(p["mu"][2], x, xs) @ p["w_v"])
    wdec = heads(torch.exp(-torch.exp(
        (_lerp(p["mu"][3], x, xs) @ p["w_w"]).to(torch.float32)
        + p["w_bias"])))
    g = F.silu(_lerp(p["mu"][4], x, xs) @ p["w_g"])
    if cache is None:
        # one zero state and the (H, hd) bonus table serve every row
        # unexpanded
        s0 = torch.zeros((1, hd, hd), dtype=torch.float32,
                         device=x.device).expand(G * H, hd, hd)
    else:
        s0 = cache[0].reshape(G * H, hd, hd)
    if step:
        def bh(t):
            return t[:, 0].reshape(G, H, hd)
        y1, s_end = linattn_step(bh(r), bh(k), bh(v), bh(wdec), p["u"],
                                 s0.reshape(G, H, hd, hd))
        y = y1.reshape(G * H, 1, hd)
    else:
        y, s_end = ops.rwkv6(r, k, v, wdec, p["u"], s0, chunk=chunk)
    y = layers.rmsnorm(p["ln_x"], y)                    # per-head norm
    y = y.reshape(G, H, S, hd).transpose(1, 2).reshape(*lead, S, H * hd) \
        .to(x.dtype)
    out = (y * g) @ p["w_o"]
    if span is not None:
        out = spmd.all_reduce_sum(out, tp)
    if cache is None:
        return out
    return out, (s_end.reshape(G, H, hd, hd), x[:, -1])


def rwkv_channel_mix(p, c: RWKVCfg, x, mask, site: linearize.MaskSite, *,
                     poly=None, soft=False, ties=True, cache=None, tp=None):
    """Channel-mix with the sqrelu mask site, gated through
    ``linearize.apply_masked_act`` (kernels 1 and 2), never a fused
    product, as the reference routes it.  x: (B, S, D) or stacked
    (N, B, S, D); mask: (F,) or (N, F).  A shared x under stacked masks
    runs its key projection once and reaches the stacked gate as a
    stride-0 candidate view.

    Without a cache returns y alone; ``cache=prev_x`` (B, D), the block
    input's last token, returns ``(y, x[:, -1])``.

    ``tp``: ``w_ck`` holds the rank's block of F columns and ``w_cv`` its
    rows (the mask is cut to it; the product is summed over the axis);
    ``w_cr`` (``_COL``) holds a block of the d output columns, whose
    receptance the axis gathers back to the whole d."""
    span = layers.tp_split(p["w_ck"].shape[-1], site.shape[-1], tp)
    prev = cache
    if span is not None:
        x = spmd.enter(x, tp)
        p = dict(p, mu_c=spmd.enter(p["mu_c"], tp))
        mask, poly = layers.slice_site(mask, poly, span)
        site = dataclasses.replace(site, shape=(span[1] - span[0],))
    xs = _shift(x, prev)
    xk = _lerp(p["mu_c"][0], x, xs)
    xr = _lerp(p["mu_c"][1], x, xs)
    h = xk @ p["w_ck"]
    if mask.dim() == len(site.shape) + 1 and x.dim() == 3:
        h = h.unsqueeze(0).expand((mask.shape[0],) + tuple(h.shape))
    a = linearize.apply_masked_act(h, mask, site, poly=poly, soft=soft,
                                   ties=ties)
    kv = a @ p["w_cv"]
    r = torch.sigmoid(xr @ p["w_cr"])
    if span is not None:
        kv = spmd.all_reduce_sum(kv, tp)
        r = spmd.all_gather_dim(r, -1, tp, grad="slice")
    out = kv * r
    return out if cache is None else (out, x[:, -1])
