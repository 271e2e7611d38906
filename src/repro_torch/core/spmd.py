"""A forward over a split of the eval batch, one slice per rank.

The reference shards an evaluator's eval batch over a mesh axis named
``"batch"`` and lets GSPMD keep every reduction over the batch global: its
BatchNorm takes batch statistics over axes (0, 1, 2) and its accuracies are
means over the whole batch.  The port runs one process per rank
(``torch.distributed``), each on its own slice of the batch, so those few
reductions sum over the ranks of the ``"batch"`` group explicitly.

The group is set for the duration of a forward with :func:`batch_split`
(``core.engine.ShardedEvaluator`` does so around every call that reads a
batch slice), and the models ask for it where they reduce over the batch:
:func:`batch_moments` (BatchNorm) and :func:`batch_sum` (hit counts).  With
no group set they compute exactly what they did on one rank, bit for bit.
Every rank of a group must hold a slice of the same size.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


@contextlib.contextmanager
def batch_split(group, size: int):
    """Within this block, reductions over the eval batch sum over the
    ``size`` ranks of ``group`` (a ``torch.distributed`` process group).
    ``group=None`` or ``size == 1``: no split, the one-rank arithmetic."""
    prev = getattr(_STATE, "split", None)
    _STATE.split = (group, int(size)) if group is not None and size > 1 \
        else None
    try:
        yield
    finally:
        _STATE.split = prev


def batch_ranks() -> int:
    """How many ranks share the eval batch in the current block (1 with no
    split)."""
    split = getattr(_STATE, "split", None)
    return 1 if split is None else split[1]


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the current batch split (a new
    tensor), or ``t`` itself with no split.  Sums of hit counts are
    integers, so the sum is exact in float32 in any order."""
    split = getattr(_STATE, "split", None)
    if split is None:
        return t
    import torch.distributed as dist
    out = t.contiguous().clone()
    dist.all_reduce(out, group=split[0])
    return out


def batch_moments(x: torch.Tensor, dims):
    """``(var, mean)`` over ``dims`` (keepdim), biased as ``jnp.var`` is.

    With no split this is ``torch.var_mean(unbiased=False)``, the one-rank
    path's own call.  Under a split each rank holds 1/size of the batch:
    the sum is all-reduced and divided once by the global count, then the
    centred sum of squares likewise."""
    split = getattr(_STATE, "split", None)
    if split is None:
        return torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    count = split[1]
    for d in dims:
        count *= x.shape[d]
    mean = batch_sum(x.sum(dim=dims, keepdim=True)) / count
    var = batch_sum(((x - mean) ** 2).sum(dim=dims, keepdim=True)) / count
    return var, mean
