"""Candidate-evaluation engine for BCD (Alg. 2's hot path).

Counterpart of ``repro/core/engine.py``.  One BCD outer step evaluates up to
RT candidate mask trees; the engine decides *how*.  All backends implement
the :class:`CandidateEvaluator` protocol — ``evaluate(stacked_tree) -> (n,)
accuracies`` — and are interchangeable from ``run_bcd``'s point of view:

``SequentialEvaluator``
    The reference: one forward per candidate, host loop, one read-back per
    candidate.

``BatchedEvaluator``
    Stacks the candidate axis and evaluates a whole chunk in one forward:
    the model's eval closure takes masks ``(N, *site)`` and returns ``(N,)``
    accuracies (the candidate axis is written out in the model, there is no
    vmap).  Ragged final chunks are padded to the chunk size so every chunk
    runs the same shapes.

``PipelinedEvaluator``
    Double-buffered staging on top of batched placement: :meth:`stage` pads
    a chunk, copies it to the device from pinned host memory without
    blocking, and launches the forward (CUDA launches are asynchronous), so
    the trial loop (:func:`evaluate_prefetched`) materializes and stages
    chunk k+1 while the device still computes chunk k.
    :meth:`evaluate_staged` is the one place that synchronises.

``SuffixEvaluator``
    Prefix-reuse (split-forward) evaluation: candidates are local mask
    edits, so for a chunk whose candidates all first differ from the base
    masks at/after one site, everything *before* that site is identical per
    candidate.  This backend computes that shared prefix ONCE per
    (site, step) via the model's ``forward_prefix`` (kept on the device) and
    runs only ``forward_suffix`` over the candidate axis.  Site-aware:
    ``core.bcd._select_block`` feeds it site-grouped chunks
    (:class:`SitedChunk`) in site-major order, and a cost model
    (``analysis.roofline.SuffixCostModel``) falls shallow-cut chunks back to
    the inner full-forward backend.

``ShardedEvaluator``
    Batched placement over the ranks of a ``torch.distributed`` device mesh
    (``launch.mesh``).  SPMD: every rank runs ``run_bcd`` with the same seed
    and so samples the same chunks; each evaluates its own share and one
    ``all_reduce`` of a zero-filled ``(n,)`` vector gives every rank every
    accuracy, so every rank selects the same block.  On a 2-D
    ``("cand", "batch")`` mesh the layout is chosen per call as the
    reference chooses it (:func:`chunk_layout`): a joint layout over all
    ranks, or a candidate-only one in which the ranks of a ``"batch"``
    group each run the same candidates on their slice of the eval batch
    (``core.spmd``).  :class:`PipelinedEvaluator` and
    :class:`SuffixEvaluator` take ``mesh=`` as well.

Backends must rank candidates identically: ``run_bcd`` breaks ties by first
occurrence, and all backends evaluate candidates in sampling order, so for a
given seed/config every backend selects the same block (the site-aware path
reorders *evaluation* but replays selection in sampling order).

The candidate axis begins at a chunk's first differing gate: the batched,
pipelined and suffix backends hand the model's closure the host decision
``linearize.first_differences`` (``differ=``), so the layers before it run
at B rows in every backend, as the suffix backend's cached prefix does.  A
product on the card may round a row otherwise at another row count, so
this keeps a candidate's rows up to its chunk's first differing gate the
same bits in every backend.

**One gate route per run.**  Every eval closure takes ``fused=`` and every
backend passes its run's ``fused_kernels`` to every call it makes — the
batched and pipelined forwards, the suffix backend's prefixes, suffixes and
full-forward fallbacks, and the sequential backend through its
``eval_acc`` (``make_eval_acc(fused=)``).  The fused kernels sum in their
own order, so a candidate evaluated on two routes may read two accuracies;
under one route every backend runs the same kernels at the same shapes.  A
chunk that carries share ties runs unfused in every backend (the fused
kernels do not implement the tie override).
"""
from __future__ import annotations

import collections
import inspect
import statistics
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, NamedTuple,
                    Optional, Protocol, Tuple, Union, runtime_checkable)

import numpy as np
import torch

import repro_torch
from repro_torch.convert import to_device
from . import linearize, spmd
from . import masks as M

# eval_fn: (device mask tree, one or N stacked) -> accuracy tensor [%],
# 0-d or (N,); takes ``ties=`` (see linearize.has_share_ties) and, where it
# names the keywords, ``differ=`` (linearize.first_differences: the models'
# closures then run every layer before a chunk's first differing gate at B
# rows) and ``fused=`` (the run's gate route).
EvalFn = Callable[..., torch.Tensor]


def takes_keyword(fn, name: str) -> bool:
    """Whether a closure takes the keyword ``name`` (or any keyword)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def takes_differ(fn) -> bool:
    """Whether an eval closure takes the host decision ``differ=``."""
    return takes_keyword(fn, "differ")


def host_decisions(stacked: M.MaskTree, with_differ: bool,
                   fused: Optional[bool] = None) -> dict:
    """The keywords a stacked chunk's forward takes, decided on the host:
    ``ties=``; for a closure that takes it, ``differ=``; and where
    ``fused`` is given (the closure takes it), ``fused=``: the run's route,
    unfused for a chunk that carries share ties."""
    kw = {"ties": linearize.has_share_ties(stacked)}
    if with_differ:
        kw["differ"] = linearize.first_differences(stacked)
    if fused is not None:
        kw["fused"] = bool(fused) and not kw["ties"]
    return kw


@runtime_checkable
class CandidateEvaluator(Protocol):
    """Evaluates a *stacked* candidate mask tree -> per-candidate accuracy."""

    name: str
    # Chunk size the backend wants from run_bcd's trial loop; None defers to
    # cfg.chunk_size.  Chunking never changes selection (rng burns RT draws
    # per step regardless), so this is a pure performance hint.
    preferred_chunk: Optional[int]
    # How many chunks evaluate_prefetched may stage (transfer + launch)
    # ahead of the one being consumed.  0 = strict materialize -> evaluate.
    prefetch_depth: int

    def evaluate(self, stacked: M.MaskTree) -> np.ndarray:
        """stacked: {site: (n, *shape)} -> float64 (n,) accuracies [%]."""
        ...


class StagedChunk(NamedTuple):
    """A chunk in flight: transfer + compute launched, result not read."""
    n: int                  # true candidate count (before padding)
    accs: torch.Tensor      # (n_padded,) device tensor, possibly not ready


class PrefetchAutoTuner:
    """Picks a prefetch depth from measured producer/consumer rates.

    The pipeline overlaps the *producer* (host mask materialization + pad +
    H2D transfer + launches) with the *consumer* (blocking on the device
    result, i.e. the remaining compute).  :func:`evaluate_prefetched` runs
    the first chunks of a run in strict alternation, timing both sides; the
    first sample is discarded (it pays one-time set-up such as the kernels'
    build), and once ``n_probe`` clean samples exist the depth is fixed for
    the rest of the run:

        depth = clamp(floor(consumer / producer), 1, max_depth)

    — the number of chunks the producer can stage during one consumer
    block.  Depth 1 already reaches steady-state overlap (per-chunk cost
    max(p, c)); deeper staging only buys robustness to producer jitter when
    the producer is much faster, and is capped because every staged chunk
    is wasted work on an ADT early exit.
    """

    def __init__(self, n_probe: int = 2, max_depth: int = 4):
        if n_probe < 1:
            raise ValueError(f"n_probe must be >= 1, got {n_probe}")
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.n_probe = n_probe
        self.max_depth = max_depth
        self._produce: list = []
        self._consume: list = []
        self._warmed = False      # first sample (set-up) dropped
        self.done = False

    def add_sample(self, produce_s: float, consume_s: float) -> None:
        if self.done:
            return
        if not self._warmed:
            self._warmed = True
            return
        self._produce.append(produce_s)
        self._consume.append(consume_s)
        if len(self._produce) >= self.n_probe:
            self.done = True

    def depth(self) -> int:
        p = max(statistics.median(self._produce), 1e-9)
        c = statistics.median(self._consume)
        return max(1, min(self.max_depth, int(c / p)))

    def report(self) -> dict:
        return {
            "producer_s": statistics.median(self._produce),
            "consumer_s": statistics.median(self._consume),
            "prefetch": self.depth(),
            "samples": len(self._produce),
        }


def evaluate_prefetched(evaluator, chunks: Iterable[M.MaskTree]
                        ) -> Iterator[np.ndarray]:
    """Producer/consumer loop for the trial loop.

    Yields one float64 ``(n,)`` accuracy array per chunk, in chunk order.
    When the evaluator supports staging (``stage``/``evaluate_staged``, e.g.
    :class:`PipelinedEvaluator`), up to ``prefetch_depth`` chunks beyond the
    one being consumed are kept staged: their host materialization, device
    transfer, and kernel launches all happen while earlier chunks still
    compute.  Backends without staging — or with ``prefetch_depth == 0`` —
    degrade to the strict materialize → evaluate alternation.

    The consumer may stop early (ADT exit): closing the generator drops any
    staged-but-unread chunks, and because ``chunks`` is itself pulled lazily,
    chunks beyond the staging horizon are never even materialized.  Chunk k's
    result is always yielded before chunk k+depth+1 is staged, so an early
    exit at chunk k commits at most ``depth`` chunks of wasted work.

    When the evaluator carries a live :class:`PrefetchAutoTuner`
    (``prefetch="auto"``), the first chunks run in strict alternation while
    the tuner times the producer vs the consumer; once it converges the
    evaluator's ``prefetch_depth`` is fixed for the rest of the run and the
    loop switches to staged prefetching mid-stream.  The probe phase changes
    timing only — chunk results and their order are identical.
    """
    it = iter(chunks)
    tuner = getattr(evaluator, "auto_tuner", None)
    if tuner is not None and not tuner.done and hasattr(evaluator, "stage"):
        while not tuner.done:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                return
            staged_one = evaluator.stage(chunk)
            t1 = time.perf_counter()
            accs = evaluator.evaluate_staged(staged_one)
            t2 = time.perf_counter()
            tuner.add_sample(t1 - t0, t2 - t1)
            if tuner.done:
                evaluator.prefetch_depth = tuner.depth()
                evaluator.auto_report = tuner.report()
            yield accs
    depth = int(getattr(evaluator, "prefetch_depth", 0) or 0)
    if depth <= 0 or not hasattr(evaluator, "stage"):
        for chunk in it:
            yield evaluator.evaluate(chunk)
        return
    staged: collections.deque = collections.deque()
    exhausted = False
    while True:
        while not exhausted and len(staged) <= depth:
            try:
                staged.append(evaluator.stage(next(it)))
            except StopIteration:
                exhausted = True
        if not staged:
            return
        yield evaluator.evaluate_staged(staged.popleft())


class SequentialEvaluator:
    """Reference backend: unstack and evaluate one candidate at a time.
    Its route is the one its ``eval_acc`` was built with
    (``make_eval_acc(fused=)``)."""

    name = "sequential"
    # One candidate per chunk: evaluating a whole chunk before checking the
    # ADT exit would waste up to chunk-1 forwards on this host-loop backend.
    preferred_chunk = 1
    prefetch_depth = 0

    def __init__(self, eval_acc: Callable[[M.MaskTree], float]):
        self._eval_acc = eval_acc

    def evaluate(self, stacked: M.MaskTree) -> np.ndarray:
        n = M.stacked_len(stacked)
        return np.array([float(self._eval_acc(M.index_stacked(stacked, i)))
                         for i in range(n)], dtype=np.float64)


class BatchedEvaluator:
    """Stacked-candidate backend: one forward per chunk of candidates."""

    name = "batched"
    preferred_chunk = None
    prefetch_depth = 0
    # pinned host staging + non-blocking copies (PipelinedEvaluator)
    _async_copy = False

    def __init__(self, eval_fn: EvalFn, *, pad_to: Optional[int] = None,
                 context=None, fused_kernels: bool = True, device="cuda"):
        """eval_fn: accuracy of one mask tree or of N stacked ones (device
        tensors in/out, no synchronisation).
        pad_to: pad ragged candidate axes up to this size (use the BCD
        chunk_size) so every chunk runs the same shapes.
        context: optional tree (e.g. model params) passed to eval_fn as a
        second argument, shared by the candidates.  Callers that finetune
        params between outer steps update it via :meth:`set_context`.
        fused_kernels: the run's gate route, passed as ``fused=`` to an
        eval_fn that takes it.
        device: where chunks are evaluated; the context is moved there
        once."""
        repro_torch.use_full_float32()
        self.device = torch.device(device)
        self._has_ctx = context is not None
        self.context = None if context is None else \
            to_device(context, self.device)
        self._eval_fn = eval_fn
        self._with_differ = takes_differ(eval_fn)
        self.fused_kernels = bool(fused_kernels)
        self._fused = self.fused_kernels \
            if takes_keyword(eval_fn, "fused") else None
        self._pad_to = pad_to

    def set_context(self, context) -> None:
        """Swap the auxiliary context (same tree and shapes)."""
        if not self._has_ctx:
            raise ValueError("evaluator was built without a context")
        self.context = to_device(context, self.device)

    def _device_batch(self, stacked: M.MaskTree):
        out = {}
        for k, v in stacked.items():
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            if self._async_copy and self.device.type == "cuda":
                # pinned source + non_blocking: the copy is queued on the
                # stream and the host goes on to stage the launches
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    # -------------------------------------------------------------- staging
    #
    # evaluate() is stage() + evaluate_staged(); splitting them lets
    # evaluate_prefetched keep later chunks' transfers AND launched
    # computations in flight while it blocks on an earlier chunk's result.
    # stage() must not read anything back from the device.

    def stage(self, stacked: M.MaskTree) -> StagedChunk:
        """Pad, start the host→device transfer, launch the computation."""
        n = M.stacked_len(stacked)
        if self._pad_to is not None and n < self._pad_to:
            stacked = M.pad_stacked(stacked, self._pad_to)
        kw = host_decisions(stacked, self._with_differ, self._fused)
        batch = self._device_batch(stacked)
        with torch.no_grad():
            accs = self._eval_fn(batch, self.context, **kw) \
                if self._has_ctx else self._eval_fn(batch, **kw)
        return StagedChunk(n, accs)

    def evaluate_staged(self, staged: StagedChunk) -> np.ndarray:
        """Block on a staged chunk's result and strip its padding."""
        accs = staged.accs.detach().to("cpu").numpy().astype(np.float64)
        return accs.reshape(-1)[:staged.n]

    def evaluate(self, stacked: M.MaskTree) -> np.ndarray:
        return self.evaluate_staged(self.stage(stacked))


def effective_chunk(evaluator, chunk_size: int) -> int:
    """The chunk size the trial loop actually uses: backends may cap it via
    ``preferred_chunk`` (SequentialEvaluator wants 1 so the ADT exit never
    pays for unevaluated chunk-mates).  Shared by ``bcd._select_block`` and
    throughput measurements so both drive the same loop."""
    return min(chunk_size,
               getattr(evaluator, "preferred_chunk", None) or chunk_size)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def context_batch_specs(context: dict, *, batch_key: str = "batch",
                        axis: str = "batch") -> dict:
    """Spec tree for an evaluator context dict: leaves under
    ``context[batch_key]`` split their leading axis over mesh axis ``axis``
    (the axis size must divide their leading dim, e.g. batch 16 over 2
    ranks); every other leaf replicates (``None``).  Feed the result to
    ``ShardedEvaluator(context_specs=...)``."""
    return {k: _tree_map(lambda _: axis if k == batch_key else None, v)
            for k, v in context.items()}


def _split_leaves(tree, specs, axis: str, index: int, parts: int):
    """The rank's slice of every leaf whose spec names ``axis``: part
    ``index`` of ``parts`` equal slices of its leading dim."""
    if isinstance(tree, dict):
        return {k: _split_leaves(v, specs[k], axis, index, parts)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_leaves(v, sp, axis, index, parts)
                          for v, sp in zip(tree, specs))
    if specs != axis:
        return tree
    b = tree.shape[0]
    if b % parts:
        raise ValueError(f"a batch of {b} does not split over {parts} "
                         f"ranks of {axis!r}")
    step = b // parts
    return tree[index * step:(index + 1) * step].contiguous()


def chunk_layout(n: int, n_dev: int, cand: int) -> Tuple[int, str]:
    """Per-call layout of a chunk of ``n`` candidates over a mesh of
    ``n_dev`` ranks, ``cand`` of them along the candidate axes: (padded
    candidate count, ``"joint"`` or ``"cand"``).

    The reference's rule, to the bit: the joint layout costs
    ceil(n / n_dev) candidate-forwards per rank, the candidate-only layout
    ceil(n / cand) forwards over 1/(n_dev / cand) of the eval batch each;
    ties prefer joint (no reduction across ranks inside a forward)."""
    batch_ax = n_dev // cand
    joint_cost = -(-n // n_dev)
    split_cost = -(-n // cand) / batch_ax
    if joint_cost <= split_cost:
        return n + (-n % n_dev), "joint"
    return n + (-n % cand), "cand"


class ShardedEvaluator(BatchedEvaluator):
    """Batched backend with the candidate axis laid across a device mesh.

    SPMD over the ranks of ``mesh`` (a ``DeviceMesh`` of
    ``launch.mesh``, covering the whole process group): every rank calls
    :meth:`evaluate` with the same chunk, evaluates its own share, writes
    its slots of a zero ``(n,)`` vector and one ``all_reduce`` sums the
    vectors — adding zeros is exact, so every rank reads every accuracy
    bit for bit.  ``all_reduce`` and ``broadcast`` are what ``gloo`` offers
    for CUDA tensors; nothing here gathers.

    1-D mesh (``make_candidate_mesh``): every axis is a candidate axis,
    counts pad up to the rank count.  2-D ``("cand", "batch")`` mesh
    (``make_cand_batch_mesh``): the layout is chosen per call
    (:func:`chunk_layout`) — chunks big enough to give every rank a
    candidate shard jointly over both axes, each candidate on the whole
    eval batch; smaller chunks over ``"cand"`` only, where the ranks of a
    ``"batch"`` group run the same candidates, each on its slice of a
    ``context_specs``-split eval batch, their BatchNorm moments and hit
    counts summed over the group (``core.spmd``).  Every keyword the forward
    takes is decided on the whole chunk, as the batched backend decides it.
    """

    name = "sharded"

    def __init__(self, eval_fn: EvalFn, mesh, *, pad_to: Optional[int] = None,
                 context=None, context_specs=None,
                 fused_kernels: bool = True, device="cuda", prepare=None):
        """``prepare``: optional ``context -> context`` applied to the
        whole context and, under the batch split, to the rank's slice
        (the suffix backend's head fold, ``SplitEval.pre``)."""
        super().__init__(eval_fn, pad_to=pad_to, context=None,
                         fused_kernels=fused_kernels, device=device)
        import torch.distributed as dist
        self._mesh = mesh
        axes = tuple(mesh.mesh_dim_names)
        ranks = mesh.mesh
        self._n_dev = int(ranks.numel())
        if self._n_dev != dist.get_world_size():
            raise ValueError(
                f"the mesh holds {self._n_dev} ranks and the process group "
                f"{dist.get_world_size()}: a sharded evaluator needs a mesh "
                "over the whole group")
        coord = mesh.get_coordinate()
        shape = dict(zip(axes, ranks.shape))
        cand_axes = tuple(a for a in axes if a != "batch") or axes
        self._cand = int(np.prod([shape[a] for a in cand_axes]))
        self._batch = self._n_dev // self._cand
        pos = dict(zip(axes, coord))
        self._joint_index = int(np.ravel_multi_index(
            tuple(coord), tuple(ranks.shape)))
        self._cand_index = int(np.ravel_multi_index(
            tuple(pos[a] for a in cand_axes),
            tuple(shape[a] for a in cand_axes)))
        self._batch_index = int(pos.get("batch", 0))
        self._batch_group = mesh.get_group("batch") \
            if "batch" in axes and self._batch > 1 else None
        self._specs = context_specs
        self._prepare = prepare
        if context_specs is not None and context is None:
            raise ValueError("context_specs given without a context")
        self._has_ctx = context is not None
        self._split_ctx = None
        if context is not None:
            self._place(context)

    def _place(self, context) -> None:
        ctx = to_device(context, self.device)
        full = ctx if self._prepare is None else self._prepare(ctx)
        self.context = full
        self._split_ctx = None
        if self._specs is not None and self._batch_group is not None:
            part = _split_leaves(ctx, self._specs, "batch",
                                 self._batch_index, self._batch)
            if self._prepare is not None:
                with spmd.batch_split(self._batch_group, self._batch):
                    part = self._prepare(part)
            self._split_ctx = part

    def set_context(self, context) -> None:
        if not self._has_ctx:
            raise ValueError("evaluator was built without a context")
        self._place(context)

    def _chunk_sharding(self, n: int) -> Tuple[int, str]:
        """Per-call layout: (padded candidate count, ``"joint"`` |
        ``"cand"``), as :func:`chunk_layout`."""
        return chunk_layout(n, self._n_dev, self._cand)

    def _cand_context(self):
        """(context, batch group) of a candidate-only shard: the rank's
        batch slice under its group where the context splits, else the
        whole context and no group."""
        if self._split_ctx is not None:
            return self._split_ctx, self._batch_group
        return self.context, None

    def _shard_bounds(self, n_pad: int, layout: str) -> Tuple[int, int, bool]:
        """This rank's candidates [lo, hi) and whether it writes them: in
        the candidate-only layout the ranks of a batch group hold the same
        shard, and the first of them writes it."""
        if layout == "joint":
            per = n_pad // self._n_dev
            return per * self._joint_index, per * (self._joint_index + 1), \
                True
        per = n_pad // self._cand
        return per * self._cand_index, per * (self._cand_index + 1), \
            self._batch_index == 0

    def _combine(self, accs: torch.Tensor, n_pad: int, lo: int, hi: int,
                 write: bool) -> torch.Tensor:
        """Every rank's shards as one (n_pad,) vector on every rank."""
        full = torch.zeros((n_pad,), dtype=torch.float32, device=self.device)
        if write:
            full[lo:hi] = accs.reshape(-1).to(torch.float32)
        if self._n_dev > 1:
            import torch.distributed as dist
            dist.all_reduce(full)
        return full

    def stage(self, stacked: M.MaskTree) -> StagedChunk:
        """Pad, lay out, evaluate this rank's share, combine."""
        n = M.stacked_len(stacked)
        n_pad, layout = self._chunk_sharding(max(n, self._pad_to or 0))
        stacked = M.pad_stacked(stacked, n_pad)
        kw = host_decisions(stacked, self._with_differ, self._fused)
        lo, hi, write = self._shard_bounds(n_pad, layout)
        batch = self._device_batch(M.slice_stacked(stacked, lo, hi))
        ctx, group = (self.context, None) if layout == "joint" \
            else self._cand_context()
        with torch.no_grad(), spmd.batch_split(group, self._batch):
            accs = self._eval_fn(batch, ctx, **kw) if self._has_ctx \
                else self._eval_fn(batch, **kw)
            return StagedChunk(n, self._combine(accs, n_pad, lo, hi, write))


class PipelinedEvaluator(ShardedEvaluator):
    """Double-buffered candidate staging (batched or sharded placement).

    ``prefetch`` chunks beyond the one being consumed stay staged: padded,
    transferred, and *launched*.  CUDA's asynchronous launches then overlap
    chunk k+1's host materialization + H2D transfer with chunk k's device
    compute, which is the wall-clock the chunk-serial BatchedEvaluator
    leaves on the table.  ``mesh=None`` keeps one-device placement; a mesh
    layers the pipeline over :class:`ShardedEvaluator`'s layouts.
    Selection is unchanged versus every other backend: chunks are consumed
    in sampling order and the ADT early exit checks chunk k's results
    before chunk k+1+prefetch is committed.

    ``prefetch="auto"`` defers the depth to a :class:`PrefetchAutoTuner`:
    the run's first chunks execute in strict alternation while producer and
    consumer rates are measured, then ``prefetch_depth`` locks in for the
    rest of the run (``auto_report`` records the measurements).
    """

    name = "pipelined"
    _async_copy = True

    def __init__(self, eval_fn: EvalFn, *, pad_to: Optional[int] = None,
                 context=None, prefetch: Union[int, str] = 1, mesh=None,
                 context_specs=None, auto_probe_chunks: int = 2,
                 auto_max_prefetch: int = 4, fused_kernels: bool = True,
                 device="cuda", prepare=None):
        if prefetch == "auto":
            self.auto_tuner = PrefetchAutoTuner(
                n_probe=auto_probe_chunks, max_depth=auto_max_prefetch)
            prefetch = 0          # strict alternation until the probe locks
        elif isinstance(prefetch, str):
            raise ValueError(
                f"prefetch must be an int >= 0 or 'auto', got {prefetch!r}")
        elif prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        else:
            self.auto_tuner = None
        self.auto_report: Optional[dict] = None
        if mesh is None:
            if context_specs is not None:
                raise ValueError("context_specs requires a mesh")
            if prepare is not None and context is not None:
                context = prepare(to_device(context, torch.device(device)))
            BatchedEvaluator.__init__(self, eval_fn, pad_to=pad_to,
                                      context=context,
                                      fused_kernels=fused_kernels,
                                      device=device)
            self._mesh = None
            self._prepare = prepare
        else:
            ShardedEvaluator.__init__(self, eval_fn, mesh, pad_to=pad_to,
                                      context=context,
                                      context_specs=context_specs,
                                      fused_kernels=fused_kernels,
                                      device=device, prepare=prepare)
        self.prefetch_depth = int(prefetch)

    def set_context(self, context) -> None:
        if self._mesh is not None:
            return ShardedEvaluator.set_context(self, context)
        if self._prepare is not None:
            context = self._prepare(to_device(context, self.device))
        BatchedEvaluator.set_context(self, context)

    def stage(self, stacked: M.MaskTree) -> StagedChunk:
        if self._mesh is None:
            return BatchedEvaluator.stage(self, stacked)
        return ShardedEvaluator.stage(self, stacked)


# ----------------------------------------------------- prefix-reuse backend


class SplitEval(NamedTuple):
    """A model's split-forward closure bundle (``make_suffix_eval_fns``).

    ``prefix(site, masks, ctx) -> cached`` and
    ``suffix(site, masks, cached, ctx) -> acc[%]`` satisfy
    ``suffix(site, m, prefix(site, m, x)) == full(m)`` for every site (the
    same operations on the same values).  ``suffix`` takes stacked masks;
    every closure takes ``fused=`` (the run's one gate route), and all but
    ``pre`` take ``ties=``.

    ``prefix_ext(from_site, to_site, masks, cached, ctx) -> cached`` extends
    an already-computed prefix by only the segments between the two cuts,
    satisfying ``prefix_ext(a, b, m, prefix(a, m, x)) == prefix(b, m, x)``.
    Optional: ``None`` disables incremental extension and the trie
    recomputes every prefix from the input.

    ``pre(ctx) -> pre_act`` is the *mask-independent head* of the network
    (input to the first gate's pre-activation — e.g. the stem conv+bn).  It
    depends only on the context, never on candidate masks, so the evaluator
    computes it ONCE per context and ships it inside the context as
    ``ctx["pre"]``; ``full`` then resumes from it, sparing every fallback
    candidate the recompute.  Optional: ``None`` keeps ``full`` folding from
    the raw input.

    ``site_repeats`` (site -> R) marks mask sites whose (R, ·) array spans
    R consecutive per-repeat cut segments starting at the site's
    ``site_segment`` entry (scanned-stack sites of sequence models).
    Grouping resolves each candidate coordinate's repeat row arithmetically
    (``masks.group_blocks_by_site`` ``repeat_sites=``), and
    :meth:`SuffixEvaluator.begin_step` diffs such sites per repeat row.
    Optional: ``None`` means every site owns exactly one segment.
    """
    prefix: Callable[..., Any]
    suffix: Callable[..., Any]
    full: EvalFn                       # (masks, ctx) -> acc: fallback path
    site_order: Tuple[str, ...]        # topological site order
    site_segment: Dict[str, int]       # site -> cut segment (prefix key)
    suffix_sites: Callable[[str], Tuple[str, ...]]
    prefix_fraction: Dict[str, float]  # site -> fwd-FLOP fraction above it
    prefix_ext: Optional[Callable[..., Any]] = None
    pre: Optional[Callable[..., Any]] = None
    site_repeats: Optional[Dict[str, int]] = None


class SitedChunk(NamedTuple):
    """A candidate chunk annotated with its shared cut site.

    ``site is None`` routes the chunk down the full-forward fallback (the
    cost model declined suffix mode, or the caller had no site info)."""
    site: Optional[str]
    stacked: M.MaskTree


def tree_nbytes(tree) -> int:
    """Total bytes of a tree's leaves (tensors or numpy arrays)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return int(tree.numel() * tree.element_size())
    return int(np.asarray(tree).nbytes)


class PrefixTrie:
    """Byte-budgeted cache of device-resident prefix activations, keyed by
    cut-segment depth.

    Because every segment has exactly one successor, the "trie" of prefixes
    is a chain: the entry at depth ``d`` is the fold of segments ``[0, d)``
    and is an ancestor of every entry at depth > d.  :meth:`lookup` returns
    the *deepest* cached entry at or above a requested depth, so a chunk
    cutting at ``d`` either hits exactly (reuse), hits an ancestor (extend by
    the segments in between — ``SplitEval.prefix_ext``), or misses (compute
    from the input).

    Eviction is LRU with a site-major (shallow-first) tie-break, bounded by
    ``budget_bytes``: after every insert the total strictly respects the
    budget, evicting least-recently-used entries first and the just-inserted
    entry last (an entry that alone exceeds the budget is dropped too — the
    caller still holds the returned reference for its in-flight launches).
    ``budget_bytes=None`` disables eviction.  Counters (``hits`` /
    ``extensions`` / ``misses`` / ``evictions``) feed reports.
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._entries: Dict[int, Any] = {}
        self._nbytes: Dict[int, int] = {}
        self._tick: Dict[int, int] = {}
        self._clock = 0
        self.hits = 0
        self.extensions = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, depth: int) -> bool:
        return depth in self._entries

    def depths(self) -> Tuple[int, ...]:
        return tuple(sorted(self._entries))

    def items(self):
        return self._entries.items()

    def total_bytes(self) -> int:
        return sum(self._nbytes.values())

    def lookup(self, depth: int) -> Optional[Tuple[int, Any]]:
        """Deepest cached ancestor at depth <= ``depth`` -> (depth, cached),
        or None.  Touches the entry's LRU tick."""
        live = [d for d in self._entries if d <= depth]
        if not live:
            return None
        d = max(live)
        self._clock += 1
        self._tick[d] = self._clock
        return d, self._entries[d]

    def insert(self, depth: int, cached, nbytes: Optional[int] = None) -> None:
        self._entries[depth] = cached
        self._nbytes[depth] = tree_nbytes(cached) if nbytes is None else nbytes
        self._clock += 1
        self._tick[depth] = self._clock
        self._evict(newest=depth)

    def keep_where(self, pred: Callable[[int], bool]) -> None:
        """Drop every entry whose depth fails ``pred`` (cross-step
        invalidation: keep depths unaffected by changed base masks)."""
        for d in [d for d in self._entries if not pred(d)]:
            self._drop(d)

    def clear(self) -> None:
        self._entries.clear()
        self._nbytes.clear()
        self._tick.clear()

    def _drop(self, depth: int) -> None:
        del self._entries[depth]
        del self._nbytes[depth]
        del self._tick[depth]

    def _evict(self, newest: int) -> None:
        if self.budget_bytes is None:
            return
        while self.total_bytes() > self.budget_bytes:
            victims = sorted((d for d in self._entries if d != newest),
                             key=lambda d: (self._tick[d], d))
            victim = victims[0] if victims else newest
            self._drop(victim)
            self.evictions += 1
            if victim == newest:
                break


class SuffixEvaluator:
    """Prefix-reuse backend: one shared prefix per (site, step), stacked
    suffix per chunk.

    The trial loop (``core.bcd._select_block``) calls :meth:`begin_step`
    with the step's base masks, then feeds :class:`SitedChunk`\\ s grouped
    site-major (``plan_sited_chunks``).  For each chunk the cut segment's
    prefix comes from a :class:`PrefixTrie` of device-resident activations:
    an exact-depth hit is reused outright; otherwise the deepest cached
    *ancestor* is extended by only the segments between its depth and the
    cut (``SplitEval.prefix_ext``), so consuming chunks shallow-to-deep
    turns the step's prefix work into one incremental pass over the network
    instead of one full prefix per segment.  Candidates never mutate sites
    above their cut, so prefixes depend only on the step's *base* masks —
    which also lets entries survive across outer steps: :meth:`begin_step`
    diffs the new base tree against the old one and keeps every entry whose
    depth is at or above no changed site (selective invalidation).
    Residency is bounded by ``trie_budget_bytes`` (LRU, site-major
    tie-break).  Suffix launches ship only the *suffix-site* mask slices, so
    deep-site chunks also transfer a fraction of the mask bytes, and the
    cached prefix is read by all candidates of a chunk in place (the kernels
    take it with candidate stride 0).

    Plain (un-sited) chunks and cost-model fallbacks delegate to an inner
    :class:`PipelinedEvaluator` sharing the same context, so this backend
    composes batched / pipelined behavior: ``prefetch`` staging works
    identically for sited chunks (stage = slice + pad + transfer + launch
    suffix), and ``prefetch="auto"`` hands the depth to the inner pipeline's
    :class:`PrefetchAutoTuner`.  When the model provides ``SplitEval.pre``
    (the mask-independent head fold — stem conv+bn), it is computed once per
    context and shipped as ``ctx["pre"]``, so even fallback candidates skip
    the head recompute: the depth-0 analogue of the prefix trie.

    ``fused_kernels`` is the run's one gate route: the prefixes, their
    extensions, the suffixes and the fallbacks all run with
    ``fused=fused_kernels``, so every hard-mask ``relu → 3x3 conv`` pair
    (CNN) or FFN gate → down-projection (LM) of every forward becomes one
    launch of the fused gate→conv or gate→matmul kernel, or none does.
    Chunks (and base trees) that carry share ties run unfused (the fused
    kernels do not implement the tie override).

    ``mesh=`` lays sited chunks over the mesh's candidate axes, each rank
    its shard, as :class:`ShardedEvaluator`'s candidate-only layout does;
    with ``context_specs`` every prefix is computed and kept on the rank's
    slice of the eval batch (``core.spmd``), so the trie never gathers.
    Fallbacks go through the inner pipeline on the same mesh.
    """

    name = "suffix"
    site_aware = True
    preferred_chunk = None

    def __init__(self, split: SplitEval, *, pad_to: Optional[int] = None,
                 context=None, prefetch: Union[int, str] = 0,
                 cost_model=None, trie_budget_bytes: Optional[int] = None,
                 fused_kernels: bool = True, mesh=None, context_specs=None,
                 device="cuda"):
        if not isinstance(context, dict) or "params" not in context \
                or "batch" not in context:
            raise ValueError(
                "SuffixEvaluator needs context={'params': …, 'batch': …} — "
                "prefix and suffix consume the eval batch and params "
                "(models' make_suffix_eval_fns contract)")
        if cost_model is None:
            from repro_torch.analysis.roofline import SuffixCostModel
            cost_model = SuffixCostModel()
        repro_torch.use_full_float32()
        self._split = split
        self._suffix_differ = takes_differ(split.suffix)
        self.cost_model = cost_model
        self.fused_kernels = bool(fused_kernels)
        self._pad_to = pad_to
        self.device = torch.device(device)
        self._mesh = mesh
        # prefetch passes straight through (including "auto": the inner
        # pipeline owns the PrefetchAutoTuner; this evaluator mirrors its
        # prefetch_depth/auto_report so evaluate_prefetched's probe loop
        # drives the tuner through the suffix staging protocol)
        self._inner = PipelinedEvaluator(
            split.full, pad_to=pad_to, context=context, prefetch=prefetch,
            mesh=mesh, context_specs=context_specs,
            fused_kernels=fused_kernels, device=self.device,
            prepare=self._with_pre)
        # one representative site per segment: sites cutting at the same
        # segment share the prefix cache entry
        self._segment_site: Dict[int, str] = {}
        for s in split.site_order:
            self._segment_site.setdefault(split.site_segment[s], s)
        self.trie = PrefixTrie(budget_bytes=trie_budget_bytes)
        self._base_masks: Optional[M.MaskTree] = None
        self._base_dev: Optional[dict] = None   # device copy, lazy per step
        self._base_ties = False

    def _with_pre(self, context):
        """Augment a device context with the mask-independent head fold
        (``ctx["pre"]``) — suffix/prefix closures ignore the extra key;
        ``split.full`` resumes from it."""
        if self._split.pre is None:
            return context
        with torch.no_grad():
            pre = self._split.pre(context, fused=self.fused_kernels)
        return {**context, "pre": pre}

    # the inner pipeline owns the staging depth and (for prefetch="auto")
    # the tuner; mirroring them as properties lets evaluate_prefetched
    # treat this evaluator exactly like a PipelinedEvaluator
    @property
    def prefetch_depth(self) -> int:
        return self._inner.prefetch_depth

    @prefetch_depth.setter
    def prefetch_depth(self, depth) -> None:
        self._inner.prefetch_depth = int(depth)

    @property
    def auto_tuner(self):
        return self._inner.auto_tuner

    @property
    def auto_report(self):
        return self._inner.auto_report

    @auto_report.setter
    def auto_report(self, report) -> None:
        self._inner.auto_report = report

    # context lives on the inner evaluator (single source of truth)
    @property
    def context(self):
        return self._inner.context

    def set_context(self, context) -> None:
        """Swap params/batch context; cached prefixes are invalidated (they
        were computed from the old params/batch) and the mask-independent
        head fold is recomputed from the new context."""
        self._inner.set_context(context)
        self.trie.clear()

    def _sited_context(self):
        """(context, batch group) the prefixes and suffixes read: on a
        mesh the rank's batch slice under its group, as a candidate-only
        shard reads it."""
        if self._mesh is None:
            return self.context, None
        return self._inner._cand_context()

    def begin_step(self, base_masks: M.MaskTree) -> None:
        """Fix the outer step's base mask tree (what prefixes are computed
        from) and selectively invalidate the trie.  The trial loop calls
        this once per step, before any sited chunk is staged.

        A trie entry at depth ``d`` folds segments ``[0, d)``, so it reads
        exactly the base masks of sites with segment < d: diffing the new
        base tree against the previous step's, entries with
        ``d <= min(changed segments)`` are still byte-identical prefixes and
        survive.  A BCD step that only flipped coordinates at/below the
        deepest cut (the common case late in a sweep) therefore keeps its
        whole chain warm.

        Sites in ``SplitEval.site_repeats`` (scanned-stack masks spanning R
        per-repeat segments) are diffed per repeat ROW: the effective
        changed segment is the site's base segment plus the first repeat
        row that differs."""
        new = {k: np.asarray(v, dtype=np.float32)
               for k, v in base_masks.items()}
        if self._base_masks is None or set(new) != set(self._base_masks):
            self.trie.clear()
        elif len(self.trie):
            reps = self._split.site_repeats or {}
            changed = []
            for k in new:
                if np.array_equal(new[k], self._base_masks[k]):
                    continue
                seg = self._split.site_segment[k]
                rk = int(reps.get(k, 1))
                if rk > 1:
                    rows = np.any(new[k].reshape(rk, -1)
                                  != self._base_masks[k].reshape(rk, -1),
                                  axis=1)
                    seg += int(np.flatnonzero(rows)[0])
                changed.append(seg)
            if changed:
                min_seg = min(changed)
                self.trie.keep_where(lambda d: d <= min_seg)
        self._base_masks = new
        self._base_dev = None
        self._base_ties = linearize.has_share_ties(new)

    def prefix_fraction(self, site: str) -> float:
        return self._split.prefix_fraction[site]

    # ----------------------------------------------------------- internals

    def _base_masks_dev(self) -> dict:
        if self._base_masks is None:
            raise RuntimeError(
                "SuffixEvaluator.begin_step(base_masks) must be called "
                "before sited evaluation (the prefix needs the step's base "
                "mask tree)")
        if self._base_dev is None:
            self._base_dev = M.as_device(self._base_masks, self.device)
        return self._base_dev

    def covered_fraction(self, site: str) -> float:
        """Prefix-FLOP fraction already resident in the trie for a cut at
        ``site``'s segment — the planner prices suffix mode with only the
        *incremental* prefix cost (cut fraction minus this)."""
        seg = self._split.site_segment[site]
        live = [d for d in self.trie.depths() if d <= seg]
        if not live:
            return 0.0
        anc_site = self._segment_site.get(max(live))
        if anc_site is None:
            return 0.0
        return self._split.prefix_fraction[anc_site]

    def _prefix_for(self, site: str):
        seg = self._split.site_segment[site]
        hit = self.trie.lookup(seg)
        if hit is not None and hit[0] == seg:
            self.trie.hits += 1
            return hit[1]
        base = self._base_masks_dev()
        ctx, group = self._sited_context()
        kw = dict(ties=self._base_ties,
                  fused=self.fused_kernels and not self._base_ties)
        with torch.no_grad(), spmd.batch_split(group, self._batch_ranks()):
            if hit is not None and self._split.prefix_ext is not None:
                # deepest-ancestor extension: fold only [hit_depth, seg)
                from_seg, ancestor = hit
                cached = self._split.prefix_ext(
                    self._segment_site[from_seg], self._segment_site[seg],
                    base, ancestor, ctx, **kw)
                self.trie.extensions += 1
            else:
                cached = self._split.prefix(
                    self._segment_site[seg], base, ctx, **kw)
                self.trie.misses += 1
        self.trie.insert(seg, cached)
        return cached

    def _batch_ranks(self) -> int:
        return 1 if self._mesh is None else self._inner._batch

    def _stage_sited(self, site: str, stacked: M.MaskTree) -> StagedChunk:
        n = M.stacked_len(stacked)
        # ship only the masks the suffix consumes (sites at/after the cut)
        sub = {k: stacked[k] for k in self._split.suffix_sites(site)}
        n_pad = max(n, self._pad_to or 0)
        if self._mesh is not None:
            n_pad += -n_pad % self._inner._cand
        if n_pad > n:
            sub = M.pad_stacked(sub, n_pad)
        kw = host_decisions(sub, self._suffix_differ, self.fused_kernels)
        lo, hi, write = 0, n_pad, True
        if self._mesh is not None:
            lo, hi, write = self._inner._shard_bounds(n_pad, "cand")
            sub = M.slice_stacked(sub, lo, hi)
        batch = self._inner._device_batch(sub)
        cached = self._prefix_for(site)
        seg = self._split.site_segment[site]
        ctx, group = self._sited_context()
        with torch.no_grad(), spmd.batch_split(group, self._batch_ranks()):
            accs = self._split.suffix(
                self._segment_site[seg], batch, cached, ctx, **kw)
            if self._mesh is not None:
                accs = self._inner._combine(accs, n_pad, lo, hi, write)
        return StagedChunk(n, accs)

    # ------------------------------------------------------------- protocol

    def stage(self, item) -> StagedChunk:
        """Stage a chunk: ``SitedChunk`` with a site takes the suffix path;
        everything else (plain stacked trees, cost-model fallbacks) stages
        on the inner full-forward pipeline."""
        if isinstance(item, SitedChunk):
            if item.site is None:
                return self._inner.stage(item.stacked)
            return self._stage_sited(item.site, item.stacked)
        return self._inner.stage(item)

    def evaluate_staged(self, staged: StagedChunk) -> np.ndarray:
        return self._inner.evaluate_staged(staged)

    def evaluate(self, item) -> np.ndarray:
        return self.evaluate_staged(self.stage(item))


def plan_sited_chunks(evaluator: SuffixEvaluator, indices, layout: list,
                      chunk_size: int):
    """Site-major evaluation plan for the suffix backend.

    ``indices`` is either an (n, k) flat-coordinate array
    (``masks.sample_removal_indices``) or a list of typed
    :class:`masks.Move` candidates (``masks.sample_moves``).

    Returns ``(order, chunks)``: ``order`` is a permutation of candidate
    positions — grouped by the *cut segment* of each candidate's earliest
    touched site, sampling order preserved within a group — and ``chunks``
    is ``[(site | None, start, stop)]`` bounds into ``order``.  Sited
    chunks never straddle a group, so every sited chunk shares one prefix;
    groups are emitted depth-ascending, so the trie extends each prefix
    from its predecessor instead of recomputing from the input (the trie
    locality ``core.bcd._scan_sited`` relies on).  Multi-site moves (swap /
    share / add_back) group by the *shallowest* site they touch — over
    off ∪ on ∪ tie (``masks.group_moves_by_site``) — because a cached
    prefix is only reusable if it reads none of the candidate's edited
    masks.  ``site is None`` marks chunks the cost model sent down the
    full-forward fallback (shallow cut or undersized chunk); runs of
    adjacent fallback chunks are coalesced back up to ``chunk_size``
    (``masks.coalesce_fallback_chunks``) so a fragmented depth mix doesn't
    degrade the inner pipeline into ragged launches.

    Suffix-vs-fallback pricing is trie-aware: the cost model sees the cut's
    prefix fraction *and* the fraction already resident in the trie
    (``SuffixEvaluator.covered_fraction``), so a warm trie makes suffix
    mode cheaper than the analytic cold-start estimate.  The plan must be
    built after :meth:`SuffixEvaluator.begin_step` — surviving entries are
    part of the price."""
    split = evaluator._split
    if isinstance(indices, (list, tuple)):
        order, groups = M.group_moves_by_site(indices, layout,
                                              split.site_segment,
                                              repeat_sites=split.site_repeats)
    else:
        order, groups = M.group_blocks_by_site(
            indices, layout, split.site_segment,
            repeat_sites=split.site_repeats)
    raw = []
    planned_cover = 0.0   # prefixes earlier planned chunks will have cached
    for seg, g0, g1 in groups:
        site = evaluator._segment_site.get(seg)
        frac = split.prefix_fraction[site] if site is not None else 0.0
        covered = 0.0
        if site is not None:
            covered = min(max(evaluator.covered_fraction(site),
                              planned_cover), frac)
        group_sited = False
        for s, e in M.chunk_bounds(g1 - g0, chunk_size):
            n = e - s
            use = site is not None and \
                evaluator.cost_model.use_suffix(frac, n, covered)
            group_sited = group_sited or use
            raw.append((site if use else None, g0 + s, g0 + e))
        if group_sited:
            planned_cover = max(planned_cover, frac)
    return order, M.coalesce_fallback_chunks(raw, chunk_size)


def materialize_sited(flat: np.ndarray, layout: list, indices,
                      order: np.ndarray, chunks) -> Iterator[SitedChunk]:
    """Lazy :class:`SitedChunk` producer over a ``plan_sited_chunks`` plan
    (the site-aware counterpart of ``masks.materialize_chunks`` — same
    laziness contract: the prefetch pipeline pulls it, early exit closes
    it).  ``indices`` matches ``plan_sited_chunks``: an (n, k) removal
    array or a list of typed ``masks.Move`` candidates."""
    typed = isinstance(indices, (list, tuple))
    for site, s, e in chunks:
        sel = order[s:e]
        if typed:
            stacked = M.materialize_moves_from_flat(
                flat, layout, [indices[int(i)] for i in sel])
        else:
            stacked = M.materialize_from_flat(flat, layout, indices[sel])
        yield SitedChunk(site, stacked)


def make_evaluator(
    backend: str,
    *,
    eval_acc: Optional[Callable[[M.MaskTree], float]] = None,
    eval_fn: Optional[EvalFn] = None,
    mesh=None,
    pad_to: Optional[int] = None,
    context=None,
    context_specs=None,
    prefetch: Union[int, str] = 1,
    split: Optional[SplitEval] = None,
    cost_model=None,
    trie_budget_bytes: Optional[int] = None,
    fused_kernels: bool = True,
    device="cuda",
) -> CandidateEvaluator:
    """Factory: ``backend`` in {'sequential','batched','sharded',
    'pipelined','suffix'}.

    sequential needs ``eval_acc`` (host callable, built with the run's
    route: ``make_eval_acc(fused=)``); batched/sharded/pipelined need
    ``eval_fn`` (device closure over one or N stacked mask trees); suffix
    needs ``split`` (the model's ``make_suffix_eval_fns()`` bundle) plus a
    ``context`` carrying params AND the eval batch.  sharded defaults to a
    candidate mesh over the process group (``launch.mesh``; a world of 1
    in a plain run) when ``mesh`` is None; pipelined/suffix keep one-device
    placement unless a mesh is passed.  ``context_specs`` (see
    :func:`context_batch_specs`) splits the context's eval batch over the
    mesh's ``"batch"`` axis.  ``prefetch`` is a depth or ``"auto"``
    (measured-rate tuning; pipelined and suffix).  ``cost_model`` overrides
    the suffix backend's per-site fallback policy and ``trie_budget_bytes``
    bounds its prefix-trie residency.  ``fused_kernels`` is the run's gate
    route, for every backend but the sequential one, whose ``eval_acc``
    carries it.  ``device`` defaults to the card.
    """
    if backend not in ("pipelined", "suffix") and prefetch == "auto":
        raise ValueError(
            f"prefetch='auto' requires a staging pipeline (pipelined or "
            f"suffix backend); the {backend!r} backend has none to tune "
            "(integer prefetch values are ignored as a no-op hint)")
    if backend == "sequential":
        if eval_acc is None:
            raise ValueError("sequential backend needs eval_acc")
        return SequentialEvaluator(eval_acc)
    if backend == "suffix":
        if split is None:
            raise ValueError("suffix backend needs split= — the model's "
                             "make_suffix_eval_fns() bundle")
        return SuffixEvaluator(split, pad_to=pad_to, context=context,
                               prefetch=prefetch, cost_model=cost_model,
                               trie_budget_bytes=trie_budget_bytes,
                               fused_kernels=fused_kernels, mesh=mesh,
                               context_specs=context_specs, device=device)
    if backend in ("batched", "sharded", "pipelined"):
        if eval_fn is None:
            raise ValueError(f"{backend} backend needs a device eval_fn")
    if backend == "batched":
        return BatchedEvaluator(eval_fn, pad_to=pad_to, context=context,
                                fused_kernels=fused_kernels, device=device)
    if backend == "sharded":
        if mesh is None:
            from repro_torch.launch import mesh as mesh_lib
            mesh = mesh_lib.make_candidate_mesh(device=device)
        return ShardedEvaluator(eval_fn, mesh, pad_to=pad_to,
                                context=context, context_specs=context_specs,
                                fused_kernels=fused_kernels, device=device)
    if backend == "pipelined":
        return PipelinedEvaluator(eval_fn, pad_to=pad_to, context=context,
                                  prefetch=prefetch, mesh=mesh,
                                  context_specs=context_specs,
                                  fused_kernels=fused_kernels, device=device)
    raise ValueError(f"unknown evaluator backend {backend!r}; expected "
                     "'sequential' | 'batched' | 'sharded' | 'pipelined' | "
                     "'suffix'")
