"""Cost models for the candidate-evaluation engine.

Counterpart of ``repro/analysis/roofline.py``; so far the suffix engine's
per-site decision model and the analytic per-block forward FLOPs that the
LM's ``site_prefix_fractions`` are computed from.  Pure Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SuffixCostModel:
    """Per-site decision: suffix-mode (prefix once + vmapped suffix) vs the
    full-forward backends, for a chunk of ``n`` candidates cutting at a
    site with ``prefix_fraction`` f of forward FLOPs above it.

    Per-chunk cost ratio:  suffix / full = ((f - c) + (1 - f)·n) / n, where
    ``c`` is the prefix fraction already resident in the evaluator's trie
    (``covered``) — always <1 for n > 1 even cold, so the analytic *model*
    says "always suffix"; the thresholds price what it can't see: a shallow
    cut's win (f·(n-1) forwards) is smaller than its fixed overheads (one
    extra prefix pass per segment, the cached-acts residency, per-chunk
    plan/slice work), so those sites fall back to the full path
    (``use_suffix() == False`` -> the evaluator's inner pipelined backend
    evaluates the chunk).

    ``measured`` switches the decision from the analytic threshold to
    observed hardware behavior: a tuple of ``(prefix_fraction, speedup,
    chunk)`` points measured on the device in use, with the analytic ratio
    as the cold-start prior via an implicit ``(0.0, 1.0)`` anchor.  Suffix
    mode then runs wherever the interpolated measured speedup clears
    ``min_speedup``; the 5% margin absorbs launch overheads the FLOPs ratio
    can't see.
    """

    min_prefix_fraction: float = 0.05   # below this the reuse is noise
    min_chunk: int = 2                  # n=1 reuses nothing
    min_speedup: float = 1.05           # measured-mode margin over full path
    measured: Optional[Tuple[Tuple[float, float, int], ...]] = None

    def speedup(self, prefix_fraction: float, n: int,
                covered: float = 0.0) -> float:
        """Predicted candidates/sec gain of suffix mode for one chunk;
        ``covered`` discounts prefix work already cached in the trie."""
        f = min(max(prefix_fraction, 0.0), 1.0)
        c = min(max(covered, 0.0), f)
        return n / max((f - c) + (1.0 - f) * n, 1e-9)

    def predicted_speedup(self, prefix_fraction: float, n: int,
                          covered: float = 0.0) -> float:
        """Measured-mode estimate: linear interpolation over the calibrated
        ``(frac, speedup)`` points — anchored at (0, 1): zero prefix means
        zero reuse — rescaled by the analytic ratio to the requested chunk
        size and trie coverage (measurements are cold-trie, per-config
        chunk)."""
        if not self.measured:
            return self.speedup(prefix_fraction, n, covered)
        f = min(max(prefix_fraction, 0.0), 1.0)
        pts = sorted(((0.0, 1.0, n),) + tuple(self.measured))
        hi = next((p for p in pts if p[0] >= f), None)
        lo = next((p for p in reversed(pts) if p[0] <= f), pts[0])
        if hi is None:
            base = lo
        elif hi[0] == lo[0]:
            base = hi
        else:
            w = (f - lo[0]) / (hi[0] - lo[0])
            base = (f, lo[1] + w * (hi[1] - lo[1]),
                    int(round(lo[2] + w * (hi[2] - lo[2]))) or n)
        n0 = max(int(base[2]), 1)
        scale = self.speedup(f, n, covered) / max(self.speedup(f, n0), 1e-9)
        return base[1] * scale

    def use_suffix(self, prefix_fraction: float, n: int,
                   covered: float = 0.0) -> bool:
        if n < self.min_chunk:
            return False
        if self.measured:
            return (self.predicted_speedup(prefix_fraction, n, covered)
                    >= self.min_speedup)
        return prefix_fraction >= self.min_prefix_fraction


def block_fwd_flops(cfg, blk, new_tokens: float, ctx: float,
                    mode: str = "prefill"):
    """Analytic forward cost of ONE block: (flops, weight_bytes,
    decode_cache_bytes).

    The reference's ``analytic_cell`` sums this term over the whole stack
    (not ported yet); per-layer *fractions* (the suffix cost model's
    prefix_fraction — models' ``site_prefix_fractions``) share the same
    arithmetic.  ``new_tokens`` is batch×new positions, ``ctx`` the
    attention context length.
    """
    d = cfg.d_model
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    k = blk.kind
    cache_bytes = 0.0
    if k in ("dense", "moe", "attn_only"):
        f_attn_proj = 2 * new_tokens * d * (H + 2 * KV) * hd \
            + 2 * new_tokens * H * hd * d
        kv_len = min(ctx, blk.window or ctx)
        if mode == "decode":
            f_sc = 2 * new_tokens * H * hd * kv_len * 2
        else:
            # causal: average key span ~ kv_len/2 (full) or window
            span = (ctx / 2) if blk.window is None else \
                min(blk.window, ctx / 2)
            f_sc = 2 * new_tokens * H * hd * span * 2
        f = f_attn_proj + f_sc
        wb = (d * (H + 2 * KV) * hd + H * hd * d) * 2
        if mode == "decode":
            cache_bytes += new_tokens * kv_len * KV * hd * 2 * 2
        if k == "dense":
            nf = 3 if cfg.gated_ffn else 2
            f += 2 * new_tokens * d * cfg.d_ff * nf
            wb += d * cfg.d_ff * nf * 2
        elif k == "moe":
            cap = cfg.top_k * cfg.capacity_factor
            f += 2 * new_tokens * d * cfg.n_experts          # router
            f += 2 * new_tokens * cap * 3 * d * cfg.d_ff_expert
            wb += 3 * cfg.n_experts * d * cfg.d_ff_expert * 2
            if cfg.n_shared_experts:
                f += 2 * new_tokens * 3 * d * cfg.d_ff_shared
                wb += 3 * d * cfg.d_ff_shared * 2
    elif k == "mamba":
        di = cfg.d_inner
        nh = di // cfg.mamba_head_dim
        N, mh = cfg.ssm_state, cfg.mamba_head_dim
        chunk = 64 if mode != "decode" else 1
        f = 2 * new_tokens * d * 2 * di \
            + 2 * new_tokens * d * (2 * N + nh) \
            + 2 * new_tokens * di * d \
            + 4 * new_tokens * di  # conv
        # chunked SSD: scores (chunk·N) + y (chunk·mh) + state (2·N·mh)
        f += 2 * new_tokens * nh * (chunk * N + chunk * mh + 2 * N * mh)
        wb = (d * 2 * di + d * (2 * N + nh) + di * d) * 2
        if mode == "decode":
            cache_bytes += new_tokens * nh * N * mh * 4
    elif k == "rwkv":
        f_ff = cfg.d_ff
        rh = cfg.rwkv_head_dim
        Hr = d // rh
        chunk = 32 if mode != "decode" else 1
        f = 2 * new_tokens * d * d * 6 \
            + 2 * new_tokens * d * f_ff * 2 + 2 * new_tokens * d * d
        f += 2 * new_tokens * Hr * (chunk * rh * 2 + 2 * rh * rh)
        wb = (7 * d * d + 2 * d * f_ff) * 2
        if mode == "decode":
            cache_bytes += new_tokens * Hr * rh * rh * 4
    else:
        raise ValueError(k)
    return f, wb, cache_bytes


def moe_capacity_slots(cfg, seq: int) -> int:
    """Per-expert slot count of the sort-based MoE dispatch.

    Mirrors the reference's ``models.moe._capacity``: decode (seq == 1) is
    exact — one slot per expert — and everything else rounds up to a
    multiple of 8 with a floor of 8.  The expert einsums compute ALL ``E·C`` slots whether or
    not tokens fill them, so segment-level costing must use this padded
    figure, not the analytic ``top_k·capacity_factor`` per-token average.
    """
    if seq == 1:
        return 1
    cap = int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-cap // 8) * 8)


def lm_segment_fwd_flops(cfg, *, seq_len: int) -> list:
    """Per-segment forward FLOPs of the unified LM (per-sample, prefill):
    ``[embed, head…, stack repeat 0 … R-1, tail…, logits]``.

    The scanned stack contributes one entry PER REPEAT — the per-repeat
    prefix cuts in ``models.lm`` need per-repeat fractions, and every
    repeat runs the identical pattern so the entries are equal.  MoE
    blocks are corrected from :func:`block_fwd_flops`'s analytic
    ``top_k·capacity_factor`` average to the dispatch's true padded slot
    capacity (:func:`moe_capacity_slots`): the expert einsums pay for
    every ``E·C`` slot, filled or not.
    """
    def f(blk):
        fl = block_fwd_flops(cfg, blk, seq_len, seq_len, "prefill")[0]
        if blk.kind == "moe":
            analytic = seq_len * cfg.top_k * cfg.capacity_factor
            slots = cfg.n_experts * moe_capacity_slots(cfg, seq_len)
            fl += 2 * max(slots - analytic, 0.0) * 3 * cfg.d_model \
                * cfg.d_ff_expert
        return fl
    rep = sum(f(b) for b in cfg.pattern)
    return ([0.0] + [f(b) for b in cfg.head_blocks]
            + [rep] * cfg.n_repeats
            + [f(b) for b in cfg.tail]
            + [2.0 * seq_len * cfg.d_model * cfg.vocab])
