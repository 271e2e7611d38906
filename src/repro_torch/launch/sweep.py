"""Multi-budget BCD sweep driver: the paper's accuracy-vs-budget curve.

Counterpart of ``repro/launch/sweep.py``: ``make_bcd_evaluator`` wires a
model to a candidate engine, and ``run_sweep`` descends a budget schedule
with the reference's directory layout, checkpoints and artifact keys.

The headline experiment (Fig. 4 protocol) descends a budget schedule
``[B1 > B2 > ... > B_target]`` with finetuning interleaved, warm-starting
each stage from the previous stage's result and stage 0 from an SNL or
AutoReP reference checkpoint.  ``run_sweep`` turns that into a restartable
pipeline on top of ``core.runner``:

    out_dir/
        init/                    stage-init checkpoint (warm start, persisted
                                 on first run; later runs load it so a resume
                                 never depends on the caller re-deriving it)
        stage_00_b<B1>/
            ckpt/                BCDRunner checkpoints (one per accepted block)
            final/               stage-init checkpoint for stage 1's warm start
            result.json          stage summary (written only on completion)
        stage_01_b<B2>/ ...
        SWEEP_<name>.json        the curve artifact, rewritten after every
                                 stage

Kill the process at ANY point — including SIGKILL mid-stage — and rerunning
the same command resumes: completed stages are skipped via their
``result.json`` + ``final/`` checkpoint, and the in-flight stage resumes from
its newest valid runner checkpoint, replaying bit-identically (same blocks,
same logs; ``wall_s`` excepted).

**Overlapped stages** (``SweepConfig(overlap=True)``): stage ``i+1``'s BCD
descent launches the moment stage ``i``'s accepted-mask stage-init lands in
``final/``, while stage ``i``'s *reporting tail* — the per-stage
``stage_finetune`` and ``stage_eval`` scoring pass — completes concurrently
on a worker thread.  The descent lineage (masks + lightly-finetuned params)
never waits on the reporting tail in either mode, so overlapped and serial
sweeps emit bit-identical masks and step histories; only wall-clock and the
time at which ``test_acc`` lands in the artifact differ.

**Multi-host** (``coordinator=``): every rank runs the same deterministic
descent; only the writer rank commits stage-inits, summaries, and the curve
artifact (readers rendezvous at per-stage barriers and read the writer's
files).  See :mod:`repro_torch.launch.coordinator`.

**Process-wide state** (the port's): cuDNN's algorithm switches are global
to the process, and the reporting thread finetunes while the next stage's
descent evaluates.  ``run_sweep`` therefore holds
:func:`training.train.deterministic` over its stages — the descent's
evaluations and every finetune, in either thread, run under the same
switches, and the nested ``deterministic()`` of a finetune sets and restores
exactly the values already in force.  TF32 is only ever switched off
(``repro_torch.use_full_float32``), never on.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.convert import to_device
from repro_torch.core import bcd as bcd_lib
from repro_torch.core import engine, linearize
from repro_torch.core import masks as M
from repro_torch.core import runner as runner_lib
from repro_torch.training.train import deterministic


def make_bcd_evaluator(engine_name: str, model, eval_b, holder, *,
                       chunk_size: int, rt: int, prefetch=2,
                       fused_kernels: bool = True, device="cuda",
                       mesh=None):
    """Build the BCD candidate engine for any model family.

    Model-agnostic: works for every model exposing the shared eval-closure
    contract (``make_param_eval_fn`` / ``make_joint_eval_fn`` /
    ``make_suffix_eval_fns`` / ``make_eval_acc``).  Params are evaluator
    *context* because finetuning rewrites them between outer steps;
    ``holder`` is the live ``{"params": ...}`` box the caller mutates (its
    params are moved to ``device`` in place here, as is a copy of the eval
    batch).

    Returns ``(evaluator, eval_acc, set_ctx)``: call ``set_ctx(params)``
    after every finetune — engines differ in context shape (the suffix
    engine carries the eval batch alongside params), so callers never
    touch ``set_context`` directly.  ``fused_kernels`` is the run's one
    gate route, for every engine and for ``eval_acc`` (the sequential
    engine and the base accuracy of every step); pass
    ``fused_kernels="share" not in moves`` when the move set can produce
    share ties (chunks that carry ties run unfused in any case — see
    ``linearize._apply_share_ties``).  ``mesh`` (``launch.mesh``): the
    sharded engine's mesh (default: a candidate mesh over the process
    group), or a mesh for the pipelined and suffix engines; a mesh with a
    ``"batch"`` axis splits the eval batch over it.  ``device`` defaults to
    the card.
    """
    eval_b = to_device(dict(eval_b), device)
    holder["params"] = to_device(holder["params"], device)
    eval_fn_p = model.make_param_eval_fn(eval_b, device)

    def eval_acc(m):
        ties = linearize.has_share_ties(m)            # host decision
        with torch.no_grad():
            return float(eval_fn_p(M.as_device(m, device), holder["params"],
                                   ties=ties,
                                   fused=fused_kernels and not ties))
    if engine_name == "sequential":
        return engine.make_evaluator("sequential", eval_acc=eval_acc), \
            eval_acc, lambda p: None
    # don't let ragged-chunk padding exceed RT
    pad = min(chunk_size, rt)
    if engine_name == "sharded" and mesh is None:
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_candidate_mesh(device=device)
    joint = engine_name == "suffix" or (
        mesh is not None and "batch" in mesh.mesh_dim_names)
    if joint:
        # the eval batch rides in the context, split over "batch" on a mesh
        ctx = {"params": holder["params"], "batch": eval_b}
        specs = engine.context_batch_specs(ctx) \
            if mesh is not None and "batch" in mesh.mesh_dim_names else None
        kw = dict(split=model.make_suffix_eval_fns()) \
            if engine_name == "suffix" else \
            dict(eval_fn=model.make_joint_eval_fn())
        evaluator = engine.make_evaluator(
            engine_name, context=ctx, context_specs=specs, mesh=mesh,
            pad_to=pad, prefetch=prefetch, fused_kernels=fused_kernels,
            device=device, **kw)
        return evaluator, eval_acc, lambda p: evaluator.set_context(
            {"params": p, "batch": eval_b})
    evaluator = engine.make_evaluator(
        engine_name, eval_fn=eval_fn_p, pad_to=pad,
        context=holder["params"], prefetch=prefetch, mesh=mesh,
        fused_kernels=fused_kernels, device=device)
    return evaluator, eval_acc, evaluator.set_context


@dataclasses.dataclass
class SweepConfig:
    """Schedule + layout knobs for one sweep (see module docstring).

    ``overlap`` moves each stage's reporting tail (``stage_finetune`` +
    ``stage_eval``) onto a background thread so the next stage's descent
    starts immediately; mask selection is bit-identical either way.
    """

    budgets: List[int]            # strictly descending ReLU budgets
    out_dir: str
    name: str = "model"           # artifact: SWEEP_<name>.json
    checkpoint_every: int = 1
    keep: int = 3
    overlap: bool = False         # overlap stage i's reporting with i+1
    wait_timeout_s: float = 300.0   # multi-host readers: max wait for the
    #                                 writer's commit before declaring it
    #                                 dead (RunnerConfig.wait_timeout_s)
    verbose: bool = False

    def validate(self, b_init: Optional[int] = None) -> None:
        """Reject schedules that cannot descend (empty, non-descending,
        negative, or not strictly below the ``b_init`` warm-start budget)."""
        if not self.budgets:
            raise ValueError("sweep schedule is empty")
        if any(b < 0 for b in self.budgets):
            raise ValueError(f"budgets must be >= 0: {self.budgets}")
        if any(a <= b for a, b in zip(self.budgets, self.budgets[1:])):
            raise ValueError(
                f"sweep schedule must be strictly descending: {self.budgets}")
        if b_init is not None and self.budgets[0] >= b_init:
            raise ValueError(
                f"first sweep budget {self.budgets[0]} must be below the "
                f"warm-start budget {b_init}")


def _stage_dir(cfg: SweepConfig, i: int) -> str:
    return os.path.join(cfg.out_dir, f"stage_{i:02d}_b{cfg.budgets[i]}")


def init_dir(cfg: SweepConfig) -> str:
    """The persisted warm-start location (callers must not hardcode it)."""
    return os.path.join(cfg.out_dir, "init")


def artifact_path(cfg: SweepConfig) -> str:
    """Where the curve artifact (``SWEEP_<name>.json``) lands."""
    return os.path.join(cfg.out_dir, f"SWEEP_{cfg.name}.json")


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def update_notes(cfg: SweepConfig, extra: dict) -> None:
    """Atomically merge keys into the artifact's ``notes`` (e.g. the
    auto-prefetch report, known only after the run)."""
    path = artifact_path(cfg)
    with open(path) as f:
        payload = json.load(f)
    payload.setdefault("notes", {}).update(extra)
    _atomic_write_json(path, payload)


def _log_jsonable(h: bcd_lib.BCDStepLog) -> dict:
    """A step log for the curve artifact, with ``wall_s`` split out: the
    remaining fields are the run's deterministic identity (what the
    kill-and-resume smoke job compares across runs)."""
    d = dataclasses.asdict(h)
    d.pop("wall_s")
    return d


def _merged_notes(cfg: SweepConfig, notes: Optional[dict]) -> dict:
    """Caller notes merged over any already in the on-disk artifact — keys
    added out-of-band (update_notes, e.g. the auto-prefetch report) must
    survive rewrites and appear in every rank's returned payload."""
    merged = {}
    path = artifact_path(cfg)
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f).get("notes", {}) or {}
        except (json.JSONDecodeError, OSError):
            merged = {}
    merged.update(notes or {})
    return merged


def _payload(cfg: SweepConfig, stages: List[dict], complete: bool,
             notes: Optional[dict]) -> dict:
    return {
        "name": cfg.name,
        "schedule": list(cfg.budgets),
        "complete": complete,
        "stages": stages,
        "notes": _merged_notes(cfg, notes),
    }


def _write_artifact(cfg: SweepConfig, stages: List[dict],
                    complete: bool, notes: Optional[dict] = None) -> dict:
    path = artifact_path(cfg)
    payload = _payload(cfg, stages, complete, notes)
    _atomic_write_json(path, payload)
    payload["artifact"] = path
    return payload


class _StageReporter:
    """Runs each completed stage's reporting tail and folds the score back
    into ``result.json`` + the curve artifact.

    Serial mode calls :meth:`submit` inline; overlap mode runs it on a
    daemon thread so the next stage's descent proceeds immediately.  All
    file writes and ``stages`` mutations happen under one lock shared with
    the sweep loop.  A crash mid-report leaves ``result.json`` without
    ``test_acc``; the resume path notices and re-submits, so the artifact
    converges to fully-scored either way.
    """

    def __init__(self, cfg: SweepConfig, stages: List[dict],
                 stage_finetune, stage_eval, eval_test,
                 notes: Optional[dict]):
        self.cfg = cfg
        self.stages = stages
        self.lock = threading.Lock()
        self._stage_finetune = stage_finetune
        self._stage_eval = stage_eval
        self._eval_test = eval_test
        self._notes = notes
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    @property
    def scores(self) -> bool:
        """Whether any reporting callback was supplied at all."""
        return (self._stage_finetune is not None
                or self._stage_eval is not None
                or self._eval_test is not None)

    def _report(self, i: int, stage: dict, masks: M.MaskTree,
                params) -> None:
        if self._stage_finetune is not None:
            params = self._stage_finetune(params, masks)
        if self._stage_eval is not None:
            acc = float(self._stage_eval(masks, params))
        elif self._eval_test is not None:
            acc = float(self._eval_test(masks))
        else:
            return
        with self.lock:
            stage["test_acc"] = acc
            _atomic_write_json(
                os.path.join(_stage_dir(self.cfg, i), "result.json"),
                stage)
            self._fold_into_artifact(i, stage)
        if self.cfg.verbose:
            print(f"[sweep] stage {i} scored: test_acc={acc:.2f}")

    def _fold_into_artifact(self, i: int, stage: dict) -> None:
        """Merge one scored stage into the artifact (caller holds the lock).

        On a resume re-score the on-disk artifact may already describe MORE
        stages than this loop has revisited — patch the stage in place
        rather than clobbering a complete artifact with a partial stages
        list (the same crash-window rule the skip path follows).
        """
        path = artifact_path(self.cfg)
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, json.JSONDecodeError):
            existing = None
        if existing is not None and \
                len(existing.get("stages", [])) > len(self.stages) and \
                i < len(existing["stages"]):
            existing["stages"][i] = stage
            _atomic_write_json(path, existing)
        else:
            _write_artifact(self.cfg, list(self.stages), False, self._notes)

    def _report_in_thread(self, i, stage, masks, params) -> None:
        try:
            self._report(i, stage, masks, params)
        except BaseException as e:          # surfaced at join()
            self._errors.append(e)
            if not isinstance(e, Exception):
                raise

    def submit(self, i: int, stage: dict, masks: M.MaskTree,
               params) -> None:
        """Score stage ``i`` — inline (serial) or on a thread (overlap).

        ``masks``/``params`` must be snapshots the descent loop will not
        mutate: the mask tree is copied here; params are expected to be
        functionally-updated pytrees (the repo-wide convention), so holding
        the reference is safe.
        """
        if not self.scores:
            return
        masks = {k: v.copy() for k, v in masks.items()}
        if self.cfg.overlap:
            t = threading.Thread(target=self._report_in_thread,
                                 args=(i, stage, masks, params),
                                 name=f"sweep-report-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        else:
            # inline: a scoring failure aborts the sweep immediately —
            # never descend further stages on a broken reporting tail
            self._report(i, stage, masks, params)

    def join(self, reraise: bool = True) -> None:
        """Wait for in-flight reports; re-raise the first failure.

        ``reraise=False`` (the error-unwind path) still waits — abandoning
        a thread mid-write to ``result.json`` is how artifacts corrupt —
        but only prints stored scoring errors, preserving the primary
        exception already propagating.
        """
        for t in self._threads:
            t.join()
        if self._errors:
            if reraise:
                raise self._errors[0]
            for e in self._errors:
                print(f"[sweep] stage scoring also failed during unwind: "
                      f"{type(e).__name__}: {e}")


def run_sweep(
    sweep_cfg: SweepConfig,
    make_bcd_cfg: Callable[[int], bcd_lib.BCDConfig],
    eval_acc: Callable[[M.MaskTree], float],
    *,
    init: Optional[dict] = None,
    finetune: Optional[Callable[[M.MaskTree], None]] = None,
    evaluator=None,
    params_io: Optional[Tuple[Callable[[], object],
                              Callable[[object], None]]] = None,
    eval_test: Optional[Callable[[M.MaskTree], float]] = None,
    stage_finetune: Optional[Callable[[object, M.MaskTree], object]] = None,
    stage_eval: Optional[Callable[[M.MaskTree, object], float]] = None,
    notes: Optional[dict] = None,
    coordinator=None,
    device="cuda",
) -> dict:
    """Descend the budget schedule; returns the curve artifact payload.

    ``make_bcd_cfg(budget)`` builds each stage's BCDConfig (``b_target``
    must equal the budget).  ``init`` — a ``{kind, masks, params, aux}``
    warm start (e.g. ``SNLResult.stage_init()``) — is required on the first
    run and ignored afterwards: the persisted ``out_dir/init`` checkpoint
    wins, so resumed sweeps never drift from the original warm start.
    With ``params_io``, ``init["params"]`` is handed to it and removed from
    ``init``: the caller's dict keeps no second copy of the parameters
    alive through the sweep.  ``params_io`` and ``finetune`` follow the
    :class:`~repro_torch.core.runner.BCDRunner` contract.  ``notes`` is
    stored verbatim in the artifact.

    Scoring each completed stage for the curve, two forms:

    - ``eval_test(masks) -> acc`` — legacy, serial-only: it may close over
      live state (e.g. the params holder), which the next stage mutates, so
      it is rejected when ``overlap=True`` unless ``stage_eval`` is given.
    - ``stage_finetune(params, masks) -> params'`` (optional) then
      ``stage_eval(masks, params') -> acc`` — the overlap-safe reporting
      tail.  Both must be pure in their arguments (no live holders): in
      overlap mode they run on a worker thread while the next stage's
      descent mutates the live params.  The finetuned params are *reporting
      only* — the descent lineage continues from the descent-end state in
      BOTH modes, which is why overlapped and serial sweeps produce
      bit-identical masks.

    ``coordinator`` (see :mod:`repro_torch.launch.coordinator`) runs the
    sweep multi-host: all ranks descend identically, the writer rank owns
    every file, and readers rendezvous at per-stage barriers.

    ``device`` is where restored params land (warm starts, completed
    stages, runner checkpoints): the card by default.
    """
    coord = coordinator
    is_writer = coord is None or coord.is_writer
    multi = coord is not None and coord.world_size > 1
    if sweep_cfg.overlap and eval_test is not None and stage_eval is None:
        raise ValueError(
            "overlap=True cannot use eval_test(masks): it may read state "
            "the next stage's descent is mutating concurrently — pass "
            "stage_eval(masks, params) (and optionally stage_finetune), "
            "which are pure in their arguments")
    # the argument doubles as the restore template, so it is always required
    if init is None:
        raise ValueError(
            "run_sweep needs `init`: the warm start on the first run, the "
            "restore template (mask shapes / params structure) on a resume")
    # one setting of cuDNN's process-wide switches for every evaluation and
    # finetune of the sweep, in the descent and in the reporting threads
    # (module docstring); the threads are joined inside it
    with deterministic():
        return _run_stages(sweep_cfg, make_bcd_cfg, eval_acc, init,
                           finetune, evaluator, params_io, stage_finetune,
                           stage_eval, eval_test, notes, coord, is_writer,
                           multi, device)


def _run_stages(sweep_cfg, make_bcd_cfg, eval_acc, init, finetune, evaluator,
                params_io, stage_finetune, stage_eval, eval_test, notes,
                coord, is_writer, multi, device) -> dict:
    """:func:`run_sweep` after its argument checks: the warm start, the
    stages, the artifact."""
    if is_writer:
        os.makedirs(sweep_cfg.out_dir, exist_ok=True)
    init_path = init_dir(sweep_cfg)
    params_template = params_io[0]() if params_io else None

    # -- warm start: persisted init wins over the caller's argument (so a
    # resumed sweep can never drift from its original warm start)
    if is_writer:
        try:
            start = runner_lib.load_stage_init(
                init_path, init["masks"], params_template=params_template,
                device=device)
        except runner_lib.CheckpointError:      # absent/corrupt: first run
            runner_lib.save_stage_init(init_path, init)
            start = dict(init)
        if multi:
            coord.barrier("sweep_init")
    else:
        coord.barrier("sweep_init")             # wait for writer's persist
        start = runner_lib.load_stage_init(
            init_path, init["masks"], params_template=params_template,
            device=device)
    # the template's structure was all the restore needed
    del params_template
    b_init = M.relu_cost(start["masks"])
    sweep_cfg.validate(b_init)

    masks = start["masks"]
    if params_io is not None and start.get("params") is not None:
        # handed over, not kept: the live parameters are params_io's alone
        # (a full-width model has no room for a second copy on the card),
        # so the caller's ``init`` lets go of its warm start too
        init.pop("params", None)
        params_io[1](start.pop("params"))

    stages: List[dict] = []
    reporter = _StageReporter(sweep_cfg, stages, stage_finetune, stage_eval,
                              eval_test, notes)
    masks_box = [masks]
    try:
        complete = _sweep_stages(
            sweep_cfg, make_bcd_cfg, eval_acc, finetune, evaluator,
            params_io, coord, is_writer, multi, masks_box,
            stages, reporter, device)
    except BaseException:
        # the descent failed: still drain in-flight scoring threads (an
        # abandoned thread mid-write corrupts artifacts) without letting a
        # secondary scoring error mask this one
        reporter.join(reraise=False)
        raise
    reporter.join()
    masks = masks_box[0]

    complete = complete and len(stages) == len(sweep_cfg.budgets)
    if is_writer:
        payload = _write_artifact(sweep_cfg, stages, complete, notes)
    else:
        # readers return the same payload shape without writing it
        payload = _payload(sweep_cfg, stages, complete, notes)
        payload["artifact"] = artifact_path(sweep_cfg)
    payload["final_masks"] = masks
    return payload

def _sweep_stages(sweep_cfg, make_bcd_cfg, eval_acc, finetune, evaluator,
                  params_io, coord, is_writer, multi, masks_box, stages,
                  reporter, device) -> bool:
    """The per-stage descent loop of :func:`run_sweep` (its docstring has
    the contract).  Mutates ``masks_box[0]``/``stages``; returns False when
    a stage stopped early (preemption drill), True otherwise."""
    masks = masks_box[0]
    for i, budget in enumerate(sweep_cfg.budgets):
        sdir = _stage_dir(sweep_cfg, i)
        result_path = os.path.join(sdir, "result.json")
        final_dir = os.path.join(sdir, "final")
        bcd_cfg = make_bcd_cfg(budget)
        if bcd_cfg.b_target != budget:
            raise ValueError(
                f"make_bcd_cfg({budget}).b_target == {bcd_cfg.b_target}")

        # -- skip-or-run: decided from the writer's filesystem view only.
        # Ranks deciding independently could diverge (e.g. a stale NFS
        # attribute cache hiding result.json from one rank), desynchronizing
        # the use-counted rendezvous sequence — so the writer decides and
        # every rank follows its broadcast.
        done = stage = None
        if is_writer and os.path.exists(result_path):
            try:
                # completed stage: reuse its summary, warm-start from final
                done = runner_lib.load_stage_init(
                    final_dir, masks,
                    params_template=params_io[0]() if params_io else None,
                    device=device)
                with open(result_path) as f:
                    stage = json.load(f)
            except (runner_lib.CheckpointError, json.JSONDecodeError,
                    OSError):
                done = stage = None     # unusable: re-run below
        skip = done is not None
        if multi:
            skip = coord.broadcast(f"stage_plan_{i}",
                                   {"skip": skip} if is_writer else None
                                   )["skip"]
            if skip and not is_writer:
                # the writer just validated these files; a reader that
                # cannot load them is diverged, not behind — fail loudly
                # rather than re-running a completed stage solo
                done = runner_lib.load_stage_init(
                    final_dir, masks,
                    params_template=params_io[0]() if params_io else None,
                    device=device)
                with open(result_path) as f:
                    stage = json.load(f)
        if skip:
            masks = masks_box[0] = done["masks"]
            if params_io is not None and done.get("params") is not None:
                params_io[1](done["params"])
            if sweep_cfg.verbose:
                print(f"[sweep] stage {i} (b={budget}) already complete "
                      "— skipped")
            with reporter.lock:
                stages.append(stage)
            # a crash between result.json and its score leaves the
            # stage unscored — finish the reporting tail on resume
            if is_writer and reporter.scores and "test_acc" not in stage:
                reporter.submit(i, stage, done["masks"], done["params"])
            done = None         # the live parameters are params_io's alone
            # no full artifact rewrite here: nothing new happened, and
            # clobbering a complete artifact with a partial one would
            # open a crash window on an otherwise-finished sweep
            continue

        t0 = time.perf_counter()
        runner = runner_lib.BCDRunner(
            bcd_cfg,
            runner_lib.RunnerConfig(
                ckpt_dir=os.path.join(sdir, "ckpt"),
                checkpoint_every=sweep_cfg.checkpoint_every,
                keep=sweep_cfg.keep,
                wait_timeout_s=sweep_cfg.wait_timeout_s,
                verbose=sweep_cfg.verbose),
            eval_acc, finetune, evaluator=evaluator, params_io=params_io,
            coordinator=coord, device=device)
        res = runner.run(masks)
        if runner.stopped_early:
            return False
        masks = masks_box[0] = res.masks
        params_now = params_io[0]() if params_io else None

        if is_writer:
            stage = {
                "stage": i,
                "budget": budget,
                "mask_fingerprint": M.fingerprint(masks),
                "steps": len(res.history),
                "trials_total": int(sum(h.trials for h in res.history)),
                "history": [_log_jsonable(h) for h in res.history],
                "resumed_from": runner.resumed_from,
                "move_stats": res.move_stats,
                "wall_s": time.perf_counter() - t0,
            }
            # persist the stage's warm-start for its successor BEFORE the
            # summary: a crash between the two re-runs a no-op stage rather
            # than warm-starting from a missing checkpoint
            runner_lib.save_stage_init(final_dir, {
                "kind": "bcd_stage", "masks": masks, "params": params_now})
            with reporter.lock:
                _atomic_write_json(result_path, stage)
                stages.append(stage)
                _write_artifact(sweep_cfg, list(stages), False,
                                reporter._notes)
            if multi:
                coord.barrier(f"stage_done_{i}")
            # the reporting tail: inline when serial, concurrent with stage
            # i+1's descent when overlap=True — the descent lineage above
            # never depends on its output
            reporter.submit(i, stage, masks, params_now)
        else:
            coord.barrier(f"stage_done_{i}")
            with open(result_path) as f:
                stage = json.load(f)
            with reporter.lock:
                stages.append(stage)
        # the next stage's finetunes replace the live parameters: this
        # stage's must not stay alive beside them (on the card a second
        # copy of a full-width model does not fit)
        params_now = None
        if sweep_cfg.verbose:
            print(f"[sweep] stage {i} done: b={budget} "
                  f"fingerprint={stage['mask_fingerprint'][:12]}")
    return True
