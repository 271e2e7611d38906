"""Shared transformer layers: norms, RoPE, GQA attention, gated FFN.

Counterpart of ``repro/models/layers.py``: the eval path, and the KV cache
of prefill and decode (:func:`attention` with ``kv_cache=``).  Parameters
are nested dicts of tensors with the reference's keys and layouts
(``x @ w`` with ``w`` as ``(in, out)``); the rounding order of every
function follows the reference's, so a bfloat16 model rounds where the
reference rounds.

Activations are ``(B, S, D)``, or ``(N, B, S, D)`` once N stacked candidates'
activations differ.  Attention folds every leading axis into its batch; the
FFN's masked gate takes one mask ``(F,)`` or N stacked masks ``(N, F)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import linearize, spmd
from repro_torch.kernels import ops

# ---------------------------------------------------------------- init


def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """N(0, 1)·scale in float32 from ``gen``, rounded to ``dtype`` and
    placed on ``device`` (the reference draws in float32 and casts too).
    On the ``"meta"`` device nothing is drawn (shapes and dtypes only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype).to(device)


# ---------------------------------------------------------------- norms


def rmsnorm_init(d, device="cuda"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-6):
    # the variance in float32, everything after it in the stream's dtype,
    # in the reference's order
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ---------------------------------------------------------------- rope


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,) or (..., S) integers.  Computed
    in float32, returned in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: Optional[int] = None        # sliding-window size (None = full)
    rope_theta: float = 1e4


def attn_init(gen, c: AttnCfg, dtype=torch.bfloat16, device="cuda"):
    d, h, kvh, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    s = d ** -0.5
    p = {"wq": normal(gen, (d, h * hd), s, dtype, device),
         "wk": normal(gen, (d, kvh * hd), s, dtype, device),
         "wv": normal(gen, (d, kvh * hd), s, dtype, device),
         "wo": normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype, device)}
    if c.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device)
        p["k_norm"] = rmsnorm_init(hd, device)
    return p


def _attend(q, k, v, *, causal_offset=0, window, scale):
    """Causal attention, q (B, Sq, H, hd), k and v (B, Sk, KV, hd): scores
    in float32, masked with -1e30, softmax cast back to q's dtype before
    the product with v — the reference's ``_attend``.  Query i attends key
    j where ``j <= i + causal_offset`` (and ``j > i + causal_offset -
    window`` under a sliding window): ``causal_offset`` is the absolute
    position of q[0] less that of k[0], an int, or a (B,) tensor of per-row
    offsets for continuous batching, where every slot decodes at its own
    position."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qh, k).to(torch.float32)
    scores = scores * scale
    kj = torch.arange(k.shape[1], device=q.device)
    if isinstance(causal_offset, torch.Tensor):
        qi = torch.arange(Sq, device=q.device)[None, :, None] + \
            causal_offset[:, None, None]                    # (B, Sq, 1)
        mask = kj[None, None, :] <= qi
        if window is not None:
            mask &= kj[None, None, :] > qi - window
        mask = mask[:, None, None]                          # (B,1,1,Sq,Sk)
    else:
        qi = torch.arange(Sq, device=q.device)[:, None] + causal_offset
        mask = kj[None, :] <= qi
        if window is not None:
            mask &= kj[None, :] > qi - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _local_heads(p, c: AttnCfg, tp):
    """Under tensor parallelism (``tp``, the ``"model"`` axis): the
    rank's query heads are a contiguous block of ``n_heads / size`` (the
    ``_COL`` leaves ``wq``, ``wk``, ``wv`` are split on their output).  KV
    heads that divide the axis are split alike, so the local q heads group
    onto the local kv heads as they do globally; otherwise ``wk`` and
    ``wv`` are held whole and ``kv_index`` picks, for each local q head,
    its kv head.  Returns ``(h_loc, kv_loc, kv_index or None)``."""
    hd = c.head_dim
    h_loc = p["wq"].shape[-1] // hd
    kv_loc = p["wk"].shape[-1] // hd
    if kv_loc * tp.size == c.n_kv_heads:
        return h_loc, kv_loc, None
    rep = c.n_heads // c.n_kv_heads
    q = torch.arange(h_loc) + tp.index * h_loc
    return h_loc, h_loc, q // rep


def attention(p, c: AttnCfg, x, positions, *, kv_cache=None,
              cache_len=None, tp=None):
    """Causal self-attention.

    Without a cache (the eval path): x (..., S, D), every leading axis
    (batch, and the candidate axis of stacked activations) folded into the
    batch; positions (S,) integers; returns the output alone.

    With ``kv_cache=(K, V)``, each (B, max_len, KV, hd) (prefill and
    decode): x (B, S, D), positions (B, S).  k and v are written into K and
    V **in place** at ``cache_len`` — an int, or a (B,) tensor of per-row
    positions (continuous batching: each slot writes and attends at its own
    offset) — and every key at or beyond ``cache_len + S`` is zeroed before
    the products, as the reference does.  Returns ``(out, (K, V))``, the
    same two tensors.  Raises ``ValueError`` when an int ``cache_len + S``
    exceeds max_len (the reference would clamp the write).

    ``tp`` (a ``core.spmd.Axis``, the ``"model"`` axis of more than one
    rank): ``p`` holds the rank's shards (:func:`_local_heads`), the
    attention runs on the rank's heads, a KV cache holds its kv heads (all
    of them where they do not divide the axis) and the output projection
    ``wo`` (``_ROW``) gives a partial sum, summed over the axis."""
    if kv_cache is None:
        lead, (S, d) = x.shape[:-2], x.shape[-2:]
        x = x.reshape(-1, S, d)
    else:
        S = x.shape[1]
    B = x.shape[0]
    h, kvh, hd = c.n_heads, c.n_kv_heads, c.head_dim
    kv_index = None
    if tp is not None:
        h, kvh, kv_index = _local_heads(p, c, tp)
        x = spmd.enter(x, tp)
        p = _entered(p, tp, ("q_norm", "k_norm") + (
            ("wk", "wv") if kv_index is not None else ()))
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, -1, hd)
    v = (x @ p["wv"]).reshape(B, S, -1, hd)
    if c.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    scale = hd ** -0.5
    if kv_cache is None:
        if kv_index is not None:
            k, v = k[:, :, kv_index], v[:, :, kv_index]
        out = _attend(q, k, v, window=c.window, scale=scale)
        out = spmd.all_reduce_sum(out.reshape(B, S, h * hd) @ p["wo"], tp)
        return out.reshape(tuple(lead) + (S, out.shape[-1]))
    K, V = kv_cache
    kj = torch.arange(K.shape[1], device=x.device)
    if isinstance(cache_len, torch.Tensor):
        rows = torch.arange(B, device=x.device)[:, None]
        pos = cache_len[:, None] + torch.arange(S, device=x.device)[None]
        K[rows, pos] = k.to(K.dtype)
        V[rows, pos] = v.to(V.dtype)
        valid = (kj[None, :] < (cache_len + S)[:, None])[:, :, None, None]
    else:
        if cache_len + S > K.shape[1]:
            raise ValueError(f"attention: cache_len {cache_len} + {S} new "
                             f"tokens exceed the cache's {K.shape[1]}")
        K[:, cache_len:cache_len + S] = k.to(K.dtype)
        V[:, cache_len:cache_len + S] = v.to(V.dtype)
        valid = (kj < cache_len + S)[None, :, None, None]
    Kv, Vv = torch.where(valid, K, 0), torch.where(valid, V, 0)
    if kv_index is not None:
        Kv, Vv = Kv[:, :, kv_index], Vv[:, :, kv_index]
    out = _attend(q, Kv, Vv, causal_offset=cache_len, window=c.window,
                  scale=scale)
    return spmd.all_reduce_sum(out.reshape(B, S, h * hd) @ p["wo"],
                               tp), (K, V)


def _entered(p, tp, names):
    """``p`` with the leaves (or norm dicts) ``names`` passed through
    ``spmd.enter``: parameters every rank holds whole but uses on its own
    heads, whose gradients are summed over the axis."""
    out = dict(p)
    for n in names:
        if n in out:
            v = out[n]
            out[n] = {k: spmd.enter(t, tp) for k, t in v.items()} \
                if isinstance(v, dict) else spmd.enter(v, tp)
    return out


# ---------------------------------------------------------------- gated FFN


def ffn_init(gen, d, f, *, gated=True, dtype=torch.bfloat16, device="cuda"):
    s = d ** -0.5
    p = {"w_up": normal(gen, (d, f), s, dtype, device),
         "w_down": normal(gen, (f, d), f ** -0.5, dtype, device)}
    if gated:
        p["w_gate"] = normal(gen, (d, f), s, dtype, device)
    return p


def tp_split(n_local: int, n: int, tp):
    """``(lo, hi)`` of the rank's block of ``n`` channels when a leaf
    holds ``n_local`` of them under tensor parallelism ``tp``, or None
    where the leaf is whole (no ``tp``, or the channels do not split)."""
    if tp is None or n_local == n:
        return None
    return tp.index * n_local, (tp.index + 1) * n_local


def slice_site(mask, poly, span):
    """The mask ``(…, F)`` and poly ``(3, …, F)`` of a site cut to the
    channel block ``span`` (None: as they are)."""
    if span is None:
        return mask, poly
    lo, hi = span
    return mask[..., lo:hi], None if poly is None else poly[..., lo:hi]


def ffn(p, x, mask, site: linearize.MaskSite, *, poly=None, soft=False,
        fused=False, ties=True, tp=None, partial=False):
    """Gated (SwiGLU-style) or plain FFN with the *masked* activation: act(h)
    at kept channels, identity (or poly2) at linearized ones; for a gated FFN
    the gate branch is the mask site.

    x: (B, S, D), or (N, B, S, D) stacked; mask: (F,), or (N, F) for N
    stacked candidates.  Under stacked masks an un-stacked x is still shared
    by the candidates: its gate and up projections run once and reach the
    gate as stride-0 candidate views.

    ``fused`` (the port's counterpart of the reference's fused route): a
    hard mask without poly2 and without share ties runs gate, up-branch
    product and down-projection as one kernel
    (``kernels.ops.masked_act_matmul[_batched]``).  Every other case keeps
    the unfused route, the gate followed by ``torch.matmul``.

    ``tp`` (tensor parallelism over ``"model"``): ``w_gate`` and ``w_up``
    hold the rank's block of F columns (``_COL``), ``w_down`` its rows
    (``_ROW``); the mask (and poly) is cut to that block, and the
    down-projection's partial sum is summed over the axis (on the fused
    route too, at K = F / size).  ``partial``: the caller has entered x
    and sums the output itself (the MoE's shared expert, whose partial sum
    joins the routed experts' in one ``all_reduce``)."""
    gated = "w_gate" in p
    span = tp_split(p["w_up"].shape[-1], site.shape[-1], tp)
    if span is not None:
        if not partial:
            x = spmd.enter(x, tp)
        mask, poly = slice_site(mask, poly, span)
        site = dataclasses.replace(site, shape=(span[1] - span[0],))
    out = _ffn(p, x, mask, site, gated, poly, soft, fused, ties)
    return out if span is None or partial else spmd.all_reduce_sum(out, tp)


def _ffn(p, x, mask, site, gated, poly, soft, fused, ties):
    h = x @ (p["w_gate"] if gated else p["w_up"])
    mul = x @ p["w_up"] if gated else None
    stacked = mask.dim() == len(site.shape) + 1
    if stacked and x.dim() == 3:
        n = mask.shape[0]
        h = h.unsqueeze(0).expand((n,) + tuple(h.shape))
        if mul is not None:
            mul = mul.unsqueeze(0).expand((n,) + tuple(mul.shape))
    if fused and not soft and poly is None and not ties:
        if stacked:
            return ops.masked_act_matmul_batched(h, mask, p["w_down"], mul,
                                                 kind=site.kind)
        return ops.masked_act_matmul(h, mask, p["w_down"], mul,
                                     kind=site.kind)
    a = linearize.apply_masked_act(h, mask, site, poly=poly, soft=soft,
                                   ties=ties)
    if mul is not None:
        a = a * mul
    return a @ p["w_down"]

