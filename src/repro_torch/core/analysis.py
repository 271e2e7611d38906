"""Mask analytics reproducing the paper's Figs. 6 and 7.

Counterpart of ``repro/core/analysis.py`` (numpy only; a copy).

* IoU dynamics along an optimization trajectory (golden-set evidence):
  IoU(m1, m2) = ||m1 ⊙ m2||_0 / ||m1||_0 for budgets B2 > B1.
* Per-layer/site ReLU distribution at a budget.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import masks as M


def iou_matrix(snapshots: List[M.MaskTree]) -> np.ndarray:
    """IoU for every ordered snapshot pair (i later/smaller-budget than j)."""
    n = len(snapshots)
    out = np.full((n, n), np.nan)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            bi, bj = M.count(snapshots[i]), M.count(snapshots[j])
            if bi <= bj:
                out[i, j] = M.intersection_over_union(
                    snapshots[i], snapshots[j])
    return out


def consecutive_iou(snapshots: List[M.MaskTree]) -> List[float]:
    """Paper Fig. 6(a): IoU of consecutive binarized masks over epochs."""
    vals = []
    for a, b in zip(snapshots[1:], snapshots[:-1]):
        small, big = (a, b) if M.count(a) <= M.count(b) else (b, a)
        vals.append(M.intersection_over_union(small, big))
    return vals


def golden_set_fraction(snapshots: List[M.MaskTree]) -> float:
    """Fraction of ordered pairs with IoU > 0.85 (paper: ≈ 1.0)."""
    mat = iou_matrix(snapshots)
    vals = mat[~np.isnan(mat)]
    if vals.size == 0:
        return 1.0
    return float(np.mean(vals > 0.85))


def layer_distribution(masks: M.MaskTree) -> Dict[str, Tuple[int, int]]:
    """Per-site (active, total) counts — paper Fig. 7."""
    return {k: (int(np.sum(v > 0.5)), int(v.size))
            for k, v in sorted(masks.items())}
