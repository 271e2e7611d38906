"""Recurrent blocks: RWKV-6 (Finch), eval path, prefill and decode.

Counterpart of ``repro/models/ssm.py``, RWKV part, the shared chunked
linear attention and the single-token decode step (``linattn_step``);
Mamba2 comes later (``ROADMAP.md`` Queue A9).

The reference's time-mix calls its jnp ``linattn_chunked``, whose
arithmetic is that of its TPU scan kernel: here the time-mix calls
``kernels.ops.rwkv6``, which is the hand-written CUDA kernel for a CUDA
tensor and the chunked plain version for a CPU one, on ``(lead·B·H, S, hd)``
views, where ``lead`` is the candidate axis of a stacked activation.  A
decode step (one token, with a cache) takes the exact O(1) recurrence
``linattn_step`` in plain PyTorch, as the reference computes it in jnp
outside any kernel.

State locality: the recurrent state (the scan's state, the token shift's
left neighbour) lives within one block application.  Without a cache it
starts from zeros, so nothing recurrent crosses stack repeats, a cut
between repeats is a plain checkpoint of the (…, B, S, D) residual stream
and ``prefix ∘ suffix == forward`` holds as for dense blocks.  With a cache
(serving) it starts from the cache and the new state is written back into
it, block by block.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import linearize
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


def rwkv_time_mix(p, c: RWKVCfg, x, *, cache=None):
    """The time-mix of (…, B, S, D) activations; the scan runs on
    ``(G·H, S, hd)`` float32 rows, G the product of the leading axes.
    Raises ``ValueError`` when S exceeds the scan chunk and is not a
    multiple of it (the reference's ``linattn_chunked`` needs the same).

    Without a cache returns y alone (the eval contract), the scan starting
    from one zero state.  ``cache=(state, prev_x)`` — state (B, H, hd, hd)
    float32, prev_x (B, D) the block input's last token — takes x (B, S, D)
    and returns ``(y, (S_end, x[:, -1]))``: the scan starts from ``state``
    and its final state is kept; one token takes the exact recurrence
    :func:`linattn_step` instead of the scan, as the reference does."""
    *lead, S, d = x.shape
    H, hd = c.n_heads, c.head_dim
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
    y = y.reshape(G, H, S, hd).transpose(1, 2).reshape(*lead, S, d) \
        .to(x.dtype)
    out = (y * g) @ p["w_o"]
    if cache is None:
        return out
    return out, (s_end.reshape(G, H, hd, hd), x[:, -1])


def rwkv_channel_mix(p, c: RWKVCfg, x, mask, site: linearize.MaskSite, *,
                     poly=None, soft=False, ties=True, cache=None):
    """Channel-mix with the sqrelu mask site, gated through
    ``linearize.apply_masked_act`` (kernels 1 and 2), never a fused
    product, as the reference routes it.  x: (B, S, D) or stacked
    (N, B, S, D); mask: (F,) or (N, F).  A shared x under stacked masks
    runs its key projection once and reaches the stacked gate as a
    stride-0 candidate view.

    Without a cache returns y alone; ``cache=prev_x`` (B, D), the block
    input's last token, returns ``(y, x[:, -1])``."""
    xs = _shift(x, cache)
    xk = _lerp(p["mu_c"][0], x, xs)
    xr = _lerp(p["mu_c"][1], x, xs)
    h = xk @ p["w_ck"]
    if mask.dim() == len(site.shape) + 1 and x.dim() == 3:
        h = h.unsqueeze(0).expand((mask.shape[0],) + tuple(h.shape))
    a = linearize.apply_masked_act(h, mask, site, poly=poly, soft=soft,
                                   ties=ties)
    out = (a @ p["w_cv"]) * torch.sigmoid(xr @ p["w_cr"])
    return out if cache is None else (out, x[:, -1])
