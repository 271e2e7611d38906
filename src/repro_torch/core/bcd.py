"""Block Coordinate Descent for Network Linearization (the paper's Alg. 1/2).

Works directly in the discrete mask domain: every iterate is a binary mask with
exactly-known ||m||_0 — no relaxation, no hard-threshold cliff.  The algorithm
is model-agnostic: it consumes two callables,

  eval_acc(mask_tree) -> float         train-subset accuracy with these masks
  finetune(mask_tree) -> None          finetune θ in place (closure-owned)

so the same loop runs the paper's ResNets and the LM-family backbones.
Masks are plain inputs of every candidate evaluation.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import masks as M


@dataclasses.dataclass
class BCDConfig:
    b_target: int                 # target (billable) ReLU budget
    drc: int = 100                # Delta ReLU Count per outer step
    rt: int = 50                  # random trials per outer step
    adt: float = 0.3              # accuracy degradation tolerance [%]
    finetune_every_step: bool = True
    seed: int = 0
    chunk_size: int = 8           # candidates per evaluator call
    # typed-move vocabulary (masks.MOVE_KINDS subset) and proposal
    # distribution over it.  The default reproduces the paper's Alg. 2
    # exactly — single removal moves, bit-identical rng stream.
    moves: Tuple[str, ...] = ("remove",)
    proposal: str = "uniform"     # 'uniform' | 'sensitivity'

    def validate(self) -> None:
        """Raise ValueError on configs that cannot run (Alg. 2 needs at
        least one trial per step to pick a block from)."""
        if self.b_target < 0:
            raise ValueError(f"b_target must be >= 0, got {self.b_target}")
        if self.drc <= 0:
            raise ValueError(f"drc must be > 0, got {self.drc}")
        if self.rt <= 0:
            raise ValueError(
                f"rt must be > 0, got {self.rt}: every outer step needs at "
                "least one candidate trial to select a removal block")
        if self.chunk_size <= 0:
            raise ValueError(
                f"chunk_size must be > 0, got {self.chunk_size}")
        if not math.isfinite(self.adt):
            raise ValueError(f"adt must be finite, got {self.adt}")
        if not self.moves:
            raise ValueError("moves must name at least one move kind")
        for kind in self.moves:
            if kind not in M.MOVE_KINDS:
                raise ValueError(f"unknown move kind {kind!r}; expected a "
                                 f"subset of {M.MOVE_KINDS}")
        if self.proposal not in M.PROPOSALS:
            raise ValueError(f"unknown proposal {self.proposal!r}; "
                             f"expected one of {M.PROPOSALS}")


@dataclasses.dataclass
class BCDStepLog:
    step: int
    budget_before: int
    budget_after: int
    trials: int
    found_early: bool
    best_drop: float              # accepted block's accuracy drop [%]
    acc_before: float
    acc_after_finetune: Optional[float]
    wall_s: float
    # defaulted last so BCDStepLog(**h) still loads pre-move-vocabulary
    # checkpoint manifests (core.runner.restore_run_state)
    move_kind: str = "remove"     # accepted move's kind (masks.MOVE_KINDS)


@dataclasses.dataclass
class BCDResult:
    masks: M.MaskTree
    history: List[BCDStepLog]
    mask_snapshots: List[M.MaskTree]  # for IoU / golden-set analysis
    # per-kind / per-site proposed-vs-accepted counters (JSON-able) — the
    # sweep artifact's acceptance-stats payload
    move_stats: dict = dataclasses.field(default_factory=dict)


def record_move_stats(stats: dict, moves: List[M.Move], accepted_idx: int,
                      layout: list) -> None:
    """Fold one step's proposals into the running acceptance counters.

    ``stats`` is mutated in place: ``stats["kinds"][kind]`` and
    ``stats["sites"][site]`` each carry ``{"proposed", "accepted"}``
    counts.  These are both the sweep artifact's per-move acceptance stats
    and the signal the 'sensitivity' proposal samples from."""
    kinds = stats.setdefault("kinds", {})
    sites = stats.setdefault("sites", {})
    for i, mv in enumerate(moves):
        hit = 1 if i == accepted_idx else 0
        k = kinds.setdefault(mv.kind, {"proposed": 0, "accepted": 0})
        k["proposed"] += 1
        k["accepted"] += hit
        for s in M.move_sites(mv, layout):
            site = sites.setdefault(s, {"proposed": 0, "accepted": 0})
            site["proposed"] += 1
            site["accepted"] += hit


@dataclasses.dataclass
class BCDState:
    """Everything Alg. 2 carries between outer steps.

    This is the unit of persistence for resumable runs (core.runner): a run
    checkpointed after step ``t`` and restored restarts the loop at step
    ``t+1`` with the same masks and the same rng stream position, so it
    replays bit-identically against an uninterrupted run.  Model params are
    *not* part of this state — they live with the caller's finetune closure /
    evaluator context and are checkpointed alongside by the runner.
    """
    masks: M.MaskTree
    rng: np.random.Generator
    step: int                      # next outer step index (== steps done)
    b_ref: int                     # billable budget at run start
    history: List[BCDStepLog]
    snapshots: List[M.MaskTree]
    # per-kind and per-site proposed/accepted counters, fed back into the
    # 'sensitivity' proposal sampler.  Part of the resume state (the sampler
    # reads it, so bit-identical replay requires restoring it).
    move_stats: dict = dataclasses.field(default_factory=dict)


def init_state(masks: M.MaskTree, cfg: BCDConfig) -> BCDState:
    """Fresh run state: copies the masks, seeds the rng from cfg.seed."""
    cfg.validate()
    masks = {k: np.array(v, dtype=np.float32) for k, v in masks.items()}
    return BCDState(masks=masks, rng=np.random.default_rng(cfg.seed),
                    step=0, b_ref=M.relu_cost(masks), history=[],
                    snapshots=[])


def _select_block(
    masks: M.MaskTree,
    cfg: BCDConfig,
    rng: np.random.Generator,
    evaluator,
    drc_t: int,
    acc_base: float,
    *,
    move_stats: Optional[dict] = None,
    max_remove: Optional[int] = None,
):
    """One outer step's trial loop: sample RT candidate blocks, evaluate in
    chunks of ``cfg.chunk_size``, return the accepted candidate.

    The loop is a producer/consumer pipeline: the producer materializes
    chunk mask trees lazily from the pre-sampled indices, and
    ``engine.evaluate_prefetched`` stages up to ``evaluator.prefetch_depth``
    chunks (host materialization + H2D transfer + compute dispatch) ahead of
    the chunk whose results are being consumed — double-buffering for the
    PipelinedEvaluator, a plain materialize → evaluate alternation for
    everything else (prefetch_depth 0).

    Selection is backend-independent: candidates are scanned in sampling
    order; the *first* candidate with drop < adt wins (ADT early exit —
    later chunks' results are never consumed, and chunks beyond the staging
    horizon are never materialized); otherwise the first-occurrence argmin
    over all RT.  The rng always burns exactly RT draws per step so early
    exit does not desynchronize subsequent steps across backends.

    Site-aware backends (``engine.SuffixEvaluator``) evaluate in *site-major*
    order instead — candidates grouped by the segment of their earliest
    touched site, so each group shares one cached forward prefix — and
    :func:`_scan_sited` replays the sampling-order selection rules on the
    reordered results; the returned (winner, best_drop, trials, found) are
    provably identical to the sampling-order loop (see its docstring).

    Candidates are typed moves (``cfg.moves`` / ``cfg.proposal`` — see
    masks.sample_moves); all sampling happens up front, so the rng burns a
    deterministic number of draws per step regardless of evaluation order
    or early exit.  ``move_stats`` feeds the 'sensitivity' proposal;
    ``max_remove`` caps macro-moves (pass ``budget - b_target``).

    Returns (candidate_tree, best_idx, best_drop, trials_evaluated, found,
    moves) — ``moves[best_idx]`` is the accepted move.
    """
    from . import engine

    moves = M.sample_moves(rng, masks, drc_t, cfg.rt, kinds=cfg.moves,
                           proposal=cfg.proposal, move_stats=move_stats,
                           max_remove=max_remove)
    flat, layout = M._flatten(masks)     # once per step, not per chunk
    # Backends may cap the chunk (engine.effective_chunk); selection is
    # invariant under chunking either way.
    chunk_size = engine.effective_chunk(evaluator, cfg.chunk_size)
    if getattr(evaluator, "site_aware", False):
        best_idx, best_drop, n_done, found = _scan_sited(
            masks, cfg, evaluator, flat, layout, moves, chunk_size,
            acc_base)
    else:
        bounds = M.chunk_bounds(cfg.rt, chunk_size)
        best_idx, best_drop, found, n_done = -1, float("inf"), False, 0
        results = engine.evaluate_prefetched(
            evaluator,
            M.materialize_move_chunks(flat, layout, moves, chunk_size))
        try:
            for (start, _), accs in zip(bounds, results):
                drops = acc_base - np.asarray(accs, dtype=np.float64)
                for j, drop in enumerate(drops):
                    n_done += 1
                    if drop < best_drop:
                        best_idx, best_drop = start + j, float(drop)
                    if drop < cfg.adt:
                        found = True
                        break
                if found:
                    break
        finally:
            results.close()      # drop any staged-but-unread chunks
    if best_idx < 0:
        raise RuntimeError(
            "BCD trial loop produced no candidate: evaluator returned "
            f"{n_done} results for rt={cfg.rt} trials")
    cand = M.materialize_moves_from_flat(flat, layout,
                                         [moves[best_idx]])
    return (M.index_stacked(cand, 0), best_idx, best_drop, n_done, found,
            moves)


def _scan_sited(masks, cfg, evaluator, flat, layout, moves, chunk_size,
                acc_base):
    """Site-major trial scan with sampling-order selection replay.

    Chunks are evaluated grouped by cut segment in depth-ascending order
    (one cached prefix per group — ``engine.plan_sited_chunks``; ascending
    depth lets the suffix engine's prefix trie extend each cached prefix
    into the next group's deeper one instead of recomputing from the
    input), which permutes *evaluation* order.  Selection stays
    bit-identical to the sampling-order loop because its outcome is a pure
    function of the drop vector:

    * if any candidate has drop < adt, the sampling-order loop stops at the
      FIRST such index ``i*`` and returns it (every earlier candidate has
      drop >= adt > impossible-to-win), with trials = i* + 1;
    * otherwise it returns the first-occurrence argmin with trials = RT.

    This scan accumulates drops in sampling positions and applies exactly
    those rules.  Early exit: once some evaluated index i* has
    drop < adt AND all sampling positions before i* are evaluated, no
    unevaluated candidate can change the outcome — stop (at most the
    staged-ahead chunks are wasted, same bound as the prefetch loop).

    Returns (best_idx, best_drop, trials, found).
    """
    from . import engine

    rt = len(moves)
    evaluator.begin_step(masks)
    order, chunks = engine.plan_sited_chunks(evaluator, moves, layout,
                                             chunk_size)
    drops = np.full(rt, np.inf)
    evaluated = np.zeros(rt, dtype=bool)
    hit = rt                       # min sampling index with drop < adt
    results = engine.evaluate_prefetched(
        evaluator,
        engine.materialize_sited(flat, layout, moves, order, chunks))
    try:
        for (_, s, e), accs in zip(chunks, results):
            pos = order[s:e]
            d = acc_base - np.asarray(accs, dtype=np.float64)
            drops[pos] = d
            evaluated[pos] = True
            below = pos[d < cfg.adt]
            if below.size:
                hit = min(hit, int(below.min()))
            if hit < rt and evaluated[:hit].all():
                break
    finally:
        results.close()          # drop any staged-but-unread chunks
    if hit < rt and evaluated[:hit].all():
        return hit, float(drops[hit]), hit + 1, True
    return int(np.argmin(drops)), float(drops.min()), rt, False


def total_steps(b_ref: int, cfg: BCDConfig) -> int:
    """The schedule length: outer steps from ``b_ref`` down to b_target."""
    return max(0, math.ceil((b_ref - cfg.b_target) / cfg.drc))


def bcd_steps(
    state: BCDState,
    cfg: BCDConfig,
    eval_acc: Callable[[M.MaskTree], float],
    finetune: Optional[Callable[[M.MaskTree], None]] = None,
    *,
    evaluator=None,
    verbose: bool = False,
    keep_snapshots: bool = False,
):
    """Step-granular Alg. 2: yields one :class:`BCDStepLog` per accepted
    block, mutating ``state`` in place.

    This is the resumable core of :func:`run_bcd`: a caller (core.runner)
    may checkpoint ``state`` after any yield and later rebuild an identical
    generator from the restored state — the loop carries no hidden
    per-iteration context beyond ``state`` itself, so the continuation
    replays bit-identically (``wall_s`` excepted, which is wall-clock).
    """
    cfg.validate()
    if evaluator is None:
        from . import engine
        evaluator = engine.SequentialEvaluator(eval_acc)
    t_cap = total_steps(state.b_ref, cfg)
    while state.step < t_cap:
        t0 = time.perf_counter()
        budget = M.relu_cost(state.masks)
        drc_t = min(cfg.drc, budget - cfg.b_target)
        if drc_t <= 0:
            return
        acc_base = float(eval_acc(state.masks))
        masks, best_idx, best_drop, n, found, moves = _select_block(
            state.masks, cfg, state.rng, evaluator, drc_t, acc_base,
            move_stats=state.move_stats,
            max_remove=budget - cfg.b_target)
        _, layout = M._flatten(state.masks)
        record_move_stats(state.move_stats, moves, best_idx, layout)
        state.masks = masks
        acc_after = None
        if finetune is not None and cfg.finetune_every_step:
            finetune(state.masks)
            acc_after = float(eval_acc(state.masks))
        log = BCDStepLog(
            step=state.step, budget_before=budget,
            budget_after=M.relu_cost(state.masks),
            trials=n, found_early=found, best_drop=best_drop,
            acc_before=acc_base, acc_after_finetune=acc_after,
            wall_s=time.perf_counter() - t0,
            move_kind=moves[best_idx].kind)
        state.step += 1
        state.history.append(log)
        if keep_snapshots:
            state.snapshots.append(
                {k: v.copy() for k, v in state.masks.items()})
        if verbose:
            print(f"[bcd] t={log.step} budget "
                  f"{log.budget_before}->{log.budget_after}"
                  f" move={log.move_kind}"
                  f" trials={n} early={found} drop={best_drop:.3f}%"
                  f" acc={acc_base:.2f}->"
                  f"{acc_after if acc_after is not None else float('nan'):.2f}"
                  f" [{getattr(evaluator, 'name', '?')}]")
        yield log


def check_reached_target(state: BCDState, cfg: BCDConfig) -> None:
    """Raise if a completed schedule did not land exactly on b_target
    (billable budget — share-tied coordinates don't count)."""
    final = M.relu_cost(state.masks)
    if final != cfg.b_target:
        raise RuntimeError(
            f"BCD terminated at budget {final}, target {cfg.b_target} "
            f"(b_ref={state.b_ref}, drc={cfg.drc}, steps run="
            f"{len(state.history)}/{total_steps(state.b_ref, cfg)}) — the "
            "schedule did not reach the target; check drc/b_target against "
            "the initial mask count")


def run_bcd(
    masks: M.MaskTree,
    cfg: BCDConfig,
    eval_acc: Callable[[M.MaskTree], float],
    finetune: Optional[Callable[[M.MaskTree], None]] = None,
    *,
    evaluator=None,
    verbose: bool = False,
    keep_snapshots: bool = False,
) -> BCDResult:
    """Run Alg. 2 until ||m||_0 == cfg.b_target.

    Accuracies are in percent (0..100).  ΔAcc = acc(m) − acc(m⊙block).
    ``evaluator`` is a core.engine.CandidateEvaluator for the trial loop
    (defaults to SequentialEvaluator over ``eval_acc``); ``eval_acc`` is
    always used for the per-step base / post-finetune accuracies.  For
    checkpointed / resumable runs, drive :func:`bcd_steps` through
    ``core.runner.BCDRunner`` instead — this wrapper is the fire-and-forget
    path.
    """
    state = init_state(masks, cfg)
    if cfg.b_target >= state.b_ref:
        return BCDResult(state.masks, [], [])
    for _ in bcd_steps(state, cfg, eval_acc, finetune, evaluator=evaluator,
                       verbose=verbose, keep_snapshots=keep_snapshots):
        pass
    check_reached_target(state, cfg)
    return BCDResult(state.masks, state.history, state.snapshots,
                     state.move_stats)
