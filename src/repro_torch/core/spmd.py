"""Reductions over mesh axes: a forward over a split of the eval batch,
and the collectives of sharded serving and training.

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

Sharded serving and training (``models.lm.LM`` on a ``("data", "model")``
mesh) reduce over one :class:`Axis` at a time with the functions of the
second half of this module; placements are :class:`Spec` tuples.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

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


# ---------------------------------------------------- mesh-axis collectives
#
# Sharded serving and training (tensor parallelism over "model", data
# parallelism and ZeRO-3 weight sharding over "data") reduce over one mesh
# axis at a time.  ``gloo`` offers only ``all_reduce`` and ``broadcast`` on
# CUDA tensors, so every collective below is made of ``all_reduce``: a
# gather fills the rank's slot of a zero tensor and sums, a reduce-scatter
# sums and keeps the rank's slice.  Where ``nccl`` serves the group (a rank
# per card) the same calls run on it; that path has not been run on one
# card.  On an axis of one rank every function returns its input, bit for
# bit.


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its name, its process group
    (None for an axis of one rank), its size and this rank's coordinate
    along it."""

    name: str
    group: object
    size: int
    index: int

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` entries split evenly over the
        axis (``n`` must divide)."""
        if n % self.size:
            raise ValueError(f"{n} entries do not split over the "
                             f"{self.size} ranks of {self.name!r}")
        per = n // self.size
        return self.index * per, (self.index + 1) * per


def _live(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


_COLLECTIVES = {"calls": 0, "bytes": 0}


def collective_counts() -> dict:
    """``all_reduce`` calls made by this module's functions on this rank,
    and the bytes they reduced, since :func:`reset_collective_counts`."""
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    _COLLECTIVES.update(calls=0, bytes=0)


def _all_reduce(t: torch.Tensor, axis: Axis, op="sum") -> torch.Tensor:
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=ops[op], group=axis.group)
    _COLLECTIVES["calls"] += 1
    _COLLECTIVES["bytes"] += out.numel() * out.element_size()
    return out


def _gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    dim = dim % t.dim()
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * axis.size
    full = t.new_zeros(shape)
    full.narrow(dim, axis.index * n, n).copy_(t.detach())
    return _all_reduce(full, axis)


def _scatter(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    dim = dim % t.dim()
    lo, hi = axis.span(t.shape[dim])
    return _all_reduce(t, axis).narrow(dim, lo, hi - lo).contiguous()


class _Sum(torch.autograd.Function):
    """Forward: the sum over the axis; backward: the gradient as it is
    (the exit of a tensor-parallel region)."""

    @staticmethod
    def forward(ctx, t, axis):
        return _all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Forward: the tensor as it is; backward: the gradient summed over the
    axis (the entry of a tensor-parallel region)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _GatherDim(torch.autograd.Function):
    """Forward: the whole tensor from each rank's slice along ``dim``;
    backward: the gradient summed over the axis, each rank keeping its
    slice (ZeRO-3's gather and its reduce-scatter), or, where every rank
    receives the same gradient (``grad="slice"``), its slice alone."""

    @staticmethod
    def forward(ctx, t, dim, axis, grad):
        ctx.dim, ctx.axis, ctx.grad = dim, axis, grad
        return _gather(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            dim = ctx.dim % g.dim()
            lo, hi = ctx.axis.span(g.shape[dim])
            return g.narrow(dim, lo, hi - lo), None, None, None
        return _scatter(g, ctx.dim, ctx.axis), None, None, None


def all_reduce_sum(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``t`` summed over the axis's ranks; under autograd its gradient
    passes through unchanged (each rank holds the whole sum)."""
    return _Sum.apply(t, axis) if _live(axis) else t


def enter(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``t`` itself; under autograd its gradient is summed over the axis's
    ranks.  Put where a tensor that every rank holds alike starts a
    computation that differs by rank (its heads, its columns)."""
    return _Enter.apply(t, axis) if _live(axis) else t


def all_gather_dim(t: torch.Tensor, dim: int, axis: Optional[Axis],
                   grad: str = "sum") -> torch.Tensor:
    """The whole tensor from the ranks' equal slices along ``dim``, in
    rank order: each rank fills its slot of a zero tensor, then one
    ``all_reduce``.  Its gradient is :func:`reduce_scatter_dim` of the
    incoming one (``grad="sum"``: a weight gathered over ``"data"``, used
    on each rank's own batch), or the incoming one's slice
    (``grad="slice"``: an activation gathered over ``"model"``, whose
    gradient every rank holds alike)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    return _GatherDim.apply(t, dim, axis, grad) if _live(axis) else t


def reduce_scatter_dim(t: torch.Tensor, dim: int,
                       axis: Optional[Axis]) -> torch.Tensor:
    """``t`` summed over the axis's ranks, this rank's slice along ``dim``
    kept: an ``all_reduce``, then the slice.  No gradient."""
    return _scatter(t, dim, axis) if _live(axis) else t


def all_reduce_max(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise maximum over the axis's ranks.  No gradient."""
    return _all_reduce(t, axis, "max") if _live(axis) else t


def argmax(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The index of the largest entry along the last dimension of a tensor
    whose last dimension is split over the axis in rank order (vocabulary
    -sharded logits), as an index into the whole dimension: the first
    largest, as ``jnp.argmax`` takes it.  The largest value is taken over
    the ranks, then the least index among the ranks that hold it."""
    if not _live(axis):
        return t.argmax(-1)
    val, idx = t.max(-1)                     # the first largest locally
    idx = idx + axis.index * t.shape[-1]
    top = _all_reduce(val, axis, "max")
    big = torch.iinfo(torch.int64).max
    mine = torch.where(val == top, idx, torch.full_like(idx, big))
    return _all_reduce(mine, axis, "min")


class Spec(tuple):
    """A leaf's placement: one entry per dimension, a mesh axis name, a
    tuple of names (split over them in order) or None; ``Spec()`` for a
    leaf every rank holds whole.  A tuple, equal to the plain tuple of its
    entries (the reference's ``PartitionSpec`` as a tuple); its own type
    only so that a walk over a tree of them knows a leaf from a node.  A
    tuple of one axis name is that name, as ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"

    def axes(self) -> frozenset:
        """Every mesh axis the leaf is split over."""
        out = set()
        for e in self:
            if isinstance(e, (tuple, list)):
                out.update(e)
            elif e is not None:
                out.add(e)
        return frozenset(out)

    def dim_of(self, name: str) -> Optional[int]:
        """The dimension split over ``name``, or None."""
        for i, e in enumerate(self):
            if e == name or (isinstance(e, (tuple, list)) and name in e):
                return i
        return None


def local_shape(shape, spec: Spec, sizes: dict) -> tuple:
    """A leaf's shape on one rank under ``spec``, with mesh axis sizes
    ``sizes`` (name -> ranks; an axis absent from it has one)."""
    out = list(shape)
    for i, e in enumerate(spec):
        names = e if isinstance(e, (tuple, list)) else (e,)
        for n in names:
            if n is not None:
                out[i] //= sizes.get(n, 1)
    return tuple(out)
