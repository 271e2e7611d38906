"""Cost models for the candidate-evaluation engine.

Counterpart of ``repro/analysis/roofline.py``; only the suffix engine's
per-site decision model is here so far.  Pure Python.
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
