"""Cost models: the suffix engine's per-site decision and the analytic
roofline of a whole cell, at the H100's rates.

Counterpart of ``repro/analysis/roofline.py``, pure Python on the port's
configs.  The reference's module reads XLA's artifacts as well
(``xla_cost``, the HLO collective parser ``parse_collectives``): the port
has no compiler artifacts, so those have no counterpart, and a
:class:`Roofline`'s ``flops_per_device`` / ``bytes_per_device`` hold
whatever count the caller has, the analytic terms (:func:`analytic_cell`)
taking precedence as in the reference.

Three terms per (arch × shape × mesh), in seconds:
  compute    = flops_global / (chips × peak FLOP/s)
  memory     = bytes_global / (chips × HBM bandwidth)
  collective = collective_bytes_global / (chips × link bandwidth)
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

# NVIDIA H100 SXM per-card rates, dense, at 700 W (data sheet).  The port
# runs float32 outside the tensor cores (TF32 off), so a float32 cell's
# compute term takes PEAK_FLOPS_F32, a bfloat16 one PEAK_FLOPS.
PEAK_FLOPS = 989e12          # bfloat16 tensor cores
PEAK_FLOPS_TF32 = 495e12     # TF32 tensor cores
PEAK_FLOPS_F32 = 67e12       # float32, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, device memory
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction


@dataclasses.dataclass
class Roofline:
    """One cell's three roofline terms and the model's share of the roof
    (the reference's ``Roofline``).  ``flops_per_device`` /
    ``bytes_per_device``: a measured or counted per-device total (0 where
    there is none); the ``analytic_*`` globals are preferred.  The memory
    and link terms take the H100's ``HBM_BW`` / ``LINK_BW``;
    ``peak_flops`` is the rate of the cell's dtype (``PEAK_FLOPS_F32`` for
    a float32 config)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_global: float
    model_flops_global: float
    analytic_flops_global: float = 0.0   # preferred where set
    analytic_bytes_global: float = 0.0
    bytes_per_device_peak: Optional[float] = None
    peak_flops: float = PEAK_FLOPS

    @property
    def t_compute(self):
        if self.analytic_flops_global:
            return self.analytic_flops_global / (self.chips * self.peak_flops)
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self):
        if self.analytic_bytes_global:
            return self.analytic_bytes_global / (self.chips * HBM_BW)
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self):
        return self.collective_bytes_global / (self.chips * LINK_BW)

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self):
        return self.model_flops_global / max(self.hlo_flops_global, 1.0)

    @property
    def roofline_fraction(self):
        """Fraction of the hardware roof doing model math:
        (MODEL_FLOPS / chips / peak) / max(term) — 1.0 = perfect."""
        t_model = self.model_flops_global / (self.chips * self.peak_flops)
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / max(t_dom, 1e-30)

    @property
    def hlo_flops_global(self):
        """The cell's counted FLOPs, global (the reference's name: there
        the compiled module's)."""
        return self.analytic_flops_global or \
            self.flops_per_device * self.chips

    def row(self):
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_global,
            "hlo_flops_global": self.hlo_flops_global,
            "xla_flops_global_raw": self.flops_per_device * self.chips,
            "xla_bytes_global_raw": self.bytes_per_device * self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, mode: str) -> float:
    """6·N_active·D (train: ×3 fwd+bwd via the standard 6ND; inference: 2ND)."""
    n_active = active_params(cfg)
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def _iter_bench_history(path):
    """Yield parsed BENCH_history.jsonl entries, skipping malformed lines
    (the file is append-only across heterogeneous tool versions)."""
    if not os.path.exists(path):
        return
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(entry, dict):
                yield entry


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
    chunk)`` points calibrated from ``BENCH_history.jsonl``
    (:meth:`calibrated` — EWMA per site over matching config fingerprints,
    with the analytic ratio as the cold-start prior via an implicit
    ``(0.0, 1.0)`` anchor).  The history's lines come from
    ``examples/torch_family_bcd_sweep.py``'s mid-scan timing (one
    ``per_site_depth["midscan"]`` row a run, naming the model, its dtype
    and the card in ``config.model`` / ``dtype`` / ``backend``), as
    ``chip_smoke.py``'s family sweeps append them on the card; nothing in
    the pipeline passes a calibrated model by default.  Suffix mode then
    runs wherever the interpolated measured speedup clears
    ``min_speedup``; the 5% margin absorbs launch overheads the FLOPs
    ratio can't see.
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

    @classmethod
    def calibrated(cls, history_path, *, fingerprint: Optional[dict] = None,
                   alpha: float = 0.5, **kwargs) -> "SuffixCostModel":
        """Calibrate from ``BENCH_history.jsonl``'s per-depth measurements.

        Walks the history oldest-first, EWMA-folding (weight ``alpha`` on
        the newer sample) each site's measured suffix-vs-batched speedup —
        only rows the evaluator actually ran in suffix mode (``mode ==
        "suffix"``), and only entries whose config matches ``fingerprint``
        on every key the entry carries (model / device / eval-batch changes
        must not pollute each other's rates).  A point's chunk is the
        entry's ``config.chunk_size``, else the site's previous one.
        Legacy history lines without ``per_site_depth`` are skipped, so an
        empty, missing or pre-measurement file degrades to the pure
        analytic model (``measured=None``)."""
        ewma: dict = {}
        for entry in _iter_bench_history(history_path):
            cfg = entry.get("config") or {}
            if fingerprint and any(k in cfg and cfg[k] != v
                                   for k, v in fingerprint.items()):
                continue
            rows = entry.get("per_site_depth")
            if not isinstance(rows, dict):
                continue
            chunk = int(cfg.get("chunk_size") or 0)
            for row in rows.values():
                if not isinstance(row, dict) or row.get("mode") != "suffix":
                    continue
                try:
                    site = row["site"]
                    frac = float(row["prefix_fraction"])
                    sp = float(row["speedup_suffix_vs_batched"])
                except (KeyError, TypeError, ValueError):
                    continue
                prev = ewma.get(site)
                if prev is not None:
                    sp = (1 - alpha) * prev[1] + alpha * sp
                    chunk = chunk or prev[2]
                ewma[site] = (frac, sp, chunk)
        measured = tuple(sorted((f, s, max(c, 1)) for f, s, c in
                                ewma.values())) or None
        return cls(measured=measured, **kwargs)


def block_fwd_flops(cfg, blk, new_tokens: float, ctx: float,
                    mode: str = "prefill"):
    """Analytic forward cost of ONE block: (flops, weight_bytes,
    decode_cache_bytes).

    :func:`analytic_cell` sums this term over the whole stack; per-layer *fractions* (the suffix cost model's
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


def analytic_cell(cfg, shape, mode: str, *, remat: bool = True):
    """Analytic FLOPs and HBM bytes for one cell, GLOBAL (the reference's
    arithmetic, float for float).

    Counts matmul FLOPs as 2mnk, attention with the causal 1/2 factor, MoE
    at capacity (the dispatched compute incl. padding waste), and the
    chunked linear-attention intra-chunk matmuls for mamba/rwkv
    (:func:`block_fwd_flops` owns the per-block arithmetic).

    Bytes model (per step, global): weights read (fwd + bwd + remat re-fwd for
    train) + optimizer state r/w (train) + activation stream traffic
    (c·tokens·d per layer) + logits/CE traffic + cache reads (decode).
    Weights, activations, KV-cache entries and inference logits count 2
    bytes each (the configs' bfloat16): a float32 cell moves twice those
    bytes, and its caller scales them.
    """
    B, S = shape.global_batch, shape.seq_len
    d, V = cfg.d_model, cfg.vocab
    if mode == "decode":
        new_tokens, ctx = B * 1, S
    else:
        new_tokens, ctx = B * S, S
    kinds = ([b for b in cfg.head_blocks]
             + [b for b in cfg.pattern] * cfg.n_repeats
             + list(cfg.tail))

    f_layer = 0.0       # forward flops for all layers, per step (global)
    w_bytes = 0.0       # weight bytes (bf16), all layers
    cache_bytes = 0.0   # decode-state bytes read per step
    for blk in kinds:
        f, wb, cb = block_fwd_flops(cfg, blk, new_tokens, ctx, mode)
        f_layer += f
        w_bytes += wb
        cache_bytes += cb

    f_logits = 2 * new_tokens * d * V
    w_bytes += V * d * 2
    fwd = f_layer + f_logits

    if mode == "train":
        flops = fwd * (4 if remat else 3)          # fwd + re-fwd + 2×bwd
        # bytes: weights ×(2 fwd reads incl remat + 2 bwd) + grads + adam f32
        nparams = w_bytes / 2
        opt_bytes = nparams * (4 + 8 + 8 + 4 + 4)  # grad w + m/v rw + p rw
        act_bytes = 8 * new_tokens * d * len(kinds) * 2
        logit_bytes = 3 * new_tokens * V * 4   # f32 logits + CE fwd/bwd
        hbm = w_bytes * 3 + opt_bytes + act_bytes + logit_bytes
    else:
        flops = fwd
        act_bytes = 4 * new_tokens * d * len(kinds) * 2
        hbm = w_bytes + act_bytes + cache_bytes \
            + new_tokens * V * 2
    return flops, hbm


def active_params(cfg) -> float:
    """Parameter count with only top_k routed experts counted (MoE)."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    total = V * d  # embed (tied head)
    kinds = ([b.kind for b in cfg.head_blocks]
             + [b.kind for b in cfg.pattern] * cfg.n_repeats
             + [b.kind for b in cfg.tail])
    attn_p = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    ffn_p = d * f * (3 if cfg.gated_ffn else 2)
    moe_p = (cfg.top_k * 3 * d * cfg.d_ff_expert + d * cfg.n_experts
             + (3 * d * cfg.d_ff_shared if cfg.n_shared_experts else 0))
    di = cfg.d_inner
    mamba_p = d * 2 * di + d * (2 * cfg.ssm_state) + di * d
    rwkv_p = 6 * d * d + 2 * d * f
    per = {"dense": attn_p + ffn_p, "moe": attn_p + moe_p,
           "attn_only": attn_p, "mamba": mamba_p, "rwkv": rwkv_p}
    total += sum(per[k] for k in kinds)
    return float(total)
