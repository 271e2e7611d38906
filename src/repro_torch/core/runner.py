"""Resumable BCD run orchestration (crash-safe Alg. 2).

Counterpart of ``repro/core/runner.py``, writing and reading the same
checkpoints (``training/checkpoint.py`` keeps the reference's on-disk
format): a run the reference checkpointed resumes here, and the other way
round.  Restores take ``device=`` (default the card); restored masks are
host ``np.float32`` arrays, as the engines expect, and params are tensors on
``device``.

``run_bcd`` is fire-and-forget: a multi-hour descent that dies mid-run loses
everything.  :class:`BCDRunner` drives the same step-granular loop
(:func:`core.bcd.bcd_steps`) but persists the full run state through
``training.checkpoint`` after every accepted block:

    masks          the current iterate (the only thing Alg. 2 mutates)
    params         the caller's finetuned model params (via ``params_io``)
    rng state      the numpy bit-generator state, so the candidate stream
                   continues exactly where it stopped
    step / logs    outer-step index + full history (JSON, in manifest meta)

Checkpoints are atomic (tmp dir + rename) and checksummed; restore takes the
*newest valid* checkpoint, skipping a partially-written or corrupted one from
the crash itself.  Because ``bcd_steps`` carries no hidden state beyond
``BCDState``, a resumed run replays bit-identically against an uninterrupted
one — same selected blocks, same logs (``wall_s`` excepted).

The same checkpoint layout doubles as the *stage-init* warm-start format
(:func:`save_stage_init` / :func:`load_stage_init`) shared by
``SNLResult.stage_init()`` / ``AutoRepResult.stage_init()`` and by completed
sweep stages — the glue ``launch.sweep`` uses to descend a budget schedule
from an SNL or AutoReP reference checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.training import checkpoint
from . import bcd as bcd_lib
from . import masks as M

CheckpointError = checkpoint.CheckpointError

# Testing/CI hook: SIGKILL this process after N accepted blocks have been
# checkpointed (process-wide count, across sweep stages).  A real kill -9 —
# no atexit, no flushing — so the resume path is exercised against the same
# failure mode a preempted node produces.
KILL_ENV = "REPRO_KILL_AFTER_STEPS"
_accepted_in_process = 0


def _maybe_kill_for_test() -> None:
    global _accepted_in_process
    limit = os.environ.get(KILL_ENV)
    if not limit:
        return
    _accepted_in_process += 1
    if _accepted_in_process >= int(limit):
        os.kill(os.getpid(), signal.SIGKILL)


# ------------------------------------------------------------ rng round-trip


def rng_state_to_jsonable(rng: np.random.Generator) -> dict:
    """A numpy Generator's full position as JSON-able data (Python ints are
    arbitrary precision, so the 128-bit PCG64 state serializes losslessly)."""
    return rng.bit_generator.state


def rng_from_state(state: dict) -> np.random.Generator:
    """Inverse of :func:`rng_state_to_jsonable`: a Generator that continues
    the stream bit-identically from the recorded position."""
    rng = np.random.default_rng(0)
    if state["bit_generator"] != type(rng.bit_generator).__name__:
        raise CheckpointError(
            f"checkpointed rng is a {state['bit_generator']}, this numpy "
            f"builds {type(rng.bit_generator).__name__} — refusing a "
            "stream that cannot replay bit-identically")
    rng.bit_generator.state = state
    return rng


# ------------------------------------------------------------ run persistence


def _cfg_meta(cfg: bcd_lib.BCDConfig) -> dict:
    # normalize through JSON so the saved manifest (which stores JSON) and
    # the live config compare equal — e.g. cfg.moves is a tuple in memory
    # but a list on disk
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def save_run_state(state: bcd_lib.BCDState, cfg: bcd_lib.BCDConfig,
                   ckpt_dir: str, *, params=None, keep: int = 3,
                   coordinator=None) -> str:
    """Checkpoint a run after ``state.step`` accepted blocks (atomic).

    The full step history rides in every manifest (cumulative write cost
    O(steps²) over a run) — a deliberate trade for single-checkpoint
    restores: at ~150 bytes/entry the manifest stays well under a megabyte
    for thousand-step runs, dwarfed by the params leaves.  Revisit with an
    append-only sidecar if manifests ever dominate checkpoint I/O.

    ``coordinator`` stamps the writer's identity into the manifest meta
    (audit trail for the single-lineage invariant) and makes
    ``checkpoint.save`` refuse a non-writer caller outright.
    """
    tree = {"masks": state.masks}
    if params is not None:
        tree["params"] = params
    meta = {
        "algo": "bcd",
        "step": state.step,
        "b_ref": state.b_ref,
        "rng": rng_state_to_jsonable(state.rng),
        "history": [dataclasses.asdict(h) for h in state.history],
        "cfg": _cfg_meta(cfg),
        "move_stats": state.move_stats,
        "has_params": params is not None,
    }
    if coordinator is not None:
        meta["writer"] = coordinator.describe()
    return checkpoint.save(tree, ckpt_dir, state.step, meta=meta, keep=keep,
                           coordinator=coordinator)


def restore_run_state(
    ckpt_dir: str,
    cfg: bcd_lib.BCDConfig,
    masks_template: M.MaskTree,
    *,
    params_template=None,
    step: Optional[int] = None,
    verify: Optional[bool] = None,
    device="cuda",
) -> Tuple[bcd_lib.BCDState, object]:
    """Rebuild a :class:`BCDState` (+ params) from the newest valid
    checkpoint.  Refuses a checkpoint written under a different BCD config:
    resuming a run under a changed schedule/seed cannot replay
    bit-identically, which is the whole contract.

    ``verify`` defaults to hashing every leaf when ``step`` is explicit and
    skipping the re-hash when this function picked the step itself (in that
    case ``latest_valid_step`` just deep-validated it); callers that already
    deep-validated an explicit step pass ``verify=False``.  Params are
    restored onto ``device``.
    """
    if verify is None:
        verify = step is not None
    if step is None:
        step = checkpoint.latest_valid_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {ckpt_dir}")
    meta = checkpoint.read_manifest(ckpt_dir, step).get("meta", {})
    if meta.get("algo") != "bcd":
        raise CheckpointError(
            f"checkpoint step {step} in {ckpt_dir} is not a BCD run state "
            f"(algo={meta.get('algo')!r})")
    saved_cfg = meta.get("cfg", {})
    now_cfg = _cfg_meta(cfg)
    diffs = {k: (saved_cfg.get(k), now_cfg[k]) for k in now_cfg
             if saved_cfg.get(k) != now_cfg[k]}
    if diffs:
        raise CheckpointError(
            "refusing to resume under a different BCDConfig (bit-identical "
            f"replay impossible); changed fields: {diffs}")
    template = {"masks": masks_template}
    if meta.get("has_params"):
        if params_template is None:
            raise CheckpointError(
                "checkpoint carries params but no params_template was "
                "given for the restore")
        template["params"] = params_template
    tree, _ = checkpoint.restore(template, ckpt_dir, step, verify=verify,
                                 device=device)
    masks = _host_masks(tree["masks"])
    history = [bcd_lib.BCDStepLog(**h) for h in meta.get("history", [])]
    state = bcd_lib.BCDState(
        masks=masks, rng=rng_from_state(meta["rng"]),
        step=int(meta["step"]), b_ref=int(meta["b_ref"]),
        history=history, snapshots=[],
        move_stats=meta.get("move_stats", {}))
    return state, tree.get("params")


def _host_masks(masks) -> M.MaskTree:
    """Restored mask tensors as the host ``np.float32`` arrays the engines
    take."""
    return {k: v.cpu().numpy().astype(np.float32) for k, v in masks.items()}


# ------------------------------------------------------------ stage-init I/O

_STAGE_INIT_STEP = 0


def save_stage_init(path: str, init: dict, *, meta: Optional[dict] = None
                    ) -> str:
    """Persist a warm-start checkpoint in the shared stage-init layout.

    ``init`` is ``{kind, masks, params, aux}`` — what
    ``SNLResult.stage_init()`` / ``AutoRepResult.stage_init()`` return, and
    what every completed sweep stage writes for its successor.  ``aux``
    (soft alphas, poly coefficients, ...) is persisted but optional on load:
    restore reads only the leaves its template asks for.
    """
    tree = {"masks": init["masks"]}
    if init.get("params") is not None:
        tree["params"] = init["params"]
    if init.get("aux"):
        tree["aux"] = init["aux"]
    info = {
        "stage_init": True,
        "kind": init.get("kind", "unknown"),
        "budget": M.relu_cost(init["masks"]),
        "mask_fingerprint": M.fingerprint(init["masks"]),
        "has_params": init.get("params") is not None,
    }
    info.update(meta or {})
    return checkpoint.save(tree, path, _STAGE_INIT_STEP, meta=info, keep=1)


def load_stage_init(path: str, masks_template: M.MaskTree, *,
                    params_template=None, aux_template=None,
                    masks_only: bool = False, device="cuda") -> dict:
    """Load a stage-init checkpoint back into ``{kind, masks, params, aux}``.
    Raises :class:`CheckpointError` when absent/corrupted — callers decide
    whether that means "first run" or "fatal".  ``masks_only=True`` restores
    just the mask leaves even when the checkpoint carries params (the
    serving tier loads budgets, not weights).  Masks come back as host
    ``np.float32`` arrays; params and aux as tensors on ``device``."""
    if not checkpoint.validate(path, _STAGE_INIT_STEP, deep=True):
        raise CheckpointError(f"no valid stage-init checkpoint at {path}")
    meta = checkpoint.read_manifest(path, _STAGE_INIT_STEP).get("meta", {})
    if not meta.get("stage_init"):
        raise CheckpointError(f"checkpoint at {path} is not a stage init")
    template = {"masks": masks_template}
    if meta.get("has_params") and not masks_only:
        if params_template is None:
            raise CheckpointError(
                f"stage init at {path} carries params but no "
                "params_template was given")
        template["params"] = params_template
    if aux_template is not None:
        template["aux"] = aux_template
    # validate(deep=True) above already hashed every leaf
    tree, _ = checkpoint.restore(template, path, _STAGE_INIT_STEP,
                                 verify=False, device=device)
    masks = _host_masks(tree["masks"])
    return {"kind": meta.get("kind", "unknown"), "masks": masks,
            "params": tree.get("params"), "aux": tree.get("aux"),
            "meta": meta}


def stage_init_exists(path: str) -> bool:
    """Whether ``path`` holds a stage init whose leaves all pass their
    sha256."""
    return checkpoint.validate(path, _STAGE_INIT_STEP, deep=True)


# ------------------------------------------------------------------ runner


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    checkpoint_every: int = 1     # accepted blocks between checkpoints
    keep: int = 3                 # retained checkpoints (gc'd oldest-first)
    max_steps: Optional[int] = None   # stop (not fail) after N accepted
    #                                   blocks this invocation — preemption
    #                                   drills and budgeted partial runs
    wait_timeout_s: float = 300.0     # reader ranks: max wait for the
    #                                   writer's checkpoint before declaring
    #                                   the writer dead (multi-host only)
    verbose: bool = False


class BCDRunner:
    """Checkpointed, resumable ``run_bcd``.

    ``params_io`` is an optional ``(get_params, set_params)`` pair: when the
    run finetunes between steps, the current params are part of the resume
    state, and the runner snapshots them with every checkpoint and pushes
    restored params back through ``set_params`` before the loop restarts
    (the caller's ``set_params`` must also refresh any evaluator context —
    exactly like its finetune callback does).

    ``run()`` resumes automatically from the newest valid checkpoint in
    ``cfg.ckpt_dir``; a corrupted newest checkpoint falls back to the one
    before it (the replayed steps re-select the same blocks, so the result
    is unchanged — crash-consistency by determinism, not by fsync).

    ``coordinator`` (a :mod:`repro_torch.launch.coordinator` object; None
    means single-process) makes the runner multi-host safe: every rank executes
    the same deterministic loop, but only the writer rank commits
    checkpoints — reader ranks block on ``checkpoint.wait_for_step`` at each
    checkpoint point, so no rank runs ahead of durable state.  On restore,
    all ranks barrier, the writer picks the resume step and broadcasts it
    with the checkpoint's manifest fingerprint, and every rank restores that
    exact step and verifies the fingerprint — a rank on a divergent
    checkpoint lineage fails loudly instead of silently descending a
    different trajectory.

    ``device`` is where restored params land (the card by default).
    """

    def __init__(
        self,
        bcd_cfg: bcd_lib.BCDConfig,
        run_cfg: RunnerConfig,
        eval_acc: Callable[[M.MaskTree], float],
        finetune: Optional[Callable[[M.MaskTree], None]] = None,
        *,
        evaluator=None,
        params_io: Optional[Tuple[Callable[[], object],
                                  Callable[[object], None]]] = None,
        coordinator=None,
        device="cuda",
    ):
        bcd_cfg.validate()
        self.bcd_cfg = bcd_cfg
        self.run_cfg = run_cfg
        self._eval_acc = eval_acc
        self._finetune = finetune
        self._evaluator = evaluator
        self._params_io = params_io
        self._coord = coordinator
        self._device = device
        self.resumed_from: Optional[int] = None   # step, for observability
        self.stopped_early = False                # hit run_cfg.max_steps

    @property
    def _is_writer(self) -> bool:
        return self._coord is None or self._coord.is_writer

    def _resume_point(self) -> Optional[dict]:
        """Agree on the resume step across ranks (single-process: local).

        Returns ``{"step", "fingerprint"}`` or None for a fresh start.  All
        ranks barrier first so nobody inspects the directory while a
        previous attempt's writer could still be mid-commit.
        """
        coord = self._coord
        if coord is None or coord.world_size == 1:
            step = checkpoint.latest_valid_step(self.run_cfg.ckpt_dir)
            if step is None:
                return None
            return {"step": step, "fingerprint": None}
        coord.barrier("bcd_restore")
        if coord.is_writer:
            step = checkpoint.latest_valid_step(self.run_cfg.ckpt_dir)
            fp = (checkpoint.manifest_fingerprint(self.run_cfg.ckpt_dir,
                                                  step)
                  if step is not None else None)
            return coord.broadcast("bcd_resume_point",
                                   {"step": step, "fingerprint": fp})
        return coord.broadcast("bcd_resume_point")

    def _restore_or_init(self, init_masks: M.MaskTree) -> bcd_lib.BCDState:
        point = self._resume_point()
        if point is None or point["step"] is None:
            return bcd_lib.init_state(init_masks, self.bcd_cfg)
        step = point["step"]
        if point["fingerprint"] is not None:
            mine = checkpoint.manifest_fingerprint(self.run_cfg.ckpt_dir,
                                                   step)
            if mine != point["fingerprint"]:
                rank = self._coord.rank if self._coord else 0
                raise CheckpointError(
                    f"rank {rank} sees manifest fingerprint {mine[:12]} at "
                    f"step {step}, writer broadcast "
                    f"{point['fingerprint'][:12]} — divergent checkpoint "
                    "lineages; refusing to resume")
        params_template = self._params_io[0]() if self._params_io else None
        # reader ranks must hash what they read (they did not run the
        # writer's latest_valid_step validation); the rank that picked the
        # step — single-process or the writer — just deep-validated it
        picked_locally = (self._coord is None
                          or self._coord.world_size == 1
                          or self._coord.is_writer)
        state, params = restore_run_state(
            self.run_cfg.ckpt_dir, self.bcd_cfg, init_masks,
            params_template=params_template, step=step,
            verify=not picked_locally, device=self._device)
        if params is not None and self._params_io is not None:
            self._params_io[1](params)
        if self._coord is not None and self._coord.world_size > 1:
            # nobody advances (and the writer commits nothing — its keep=N
            # GC could delete the very step a slower reader is still
            # reading) until every rank finished restoring
            self._coord.barrier("bcd_restored")
        self.resumed_from = state.step
        if self.run_cfg.verbose:
            print(f"[runner] resumed {self.run_cfg.ckpt_dir} at step "
                  f"{state.step} (budget {M.relu_cost(state.masks)})")
        return state

    def _checkpoint(self, state: bcd_lib.BCDState) -> None:
        if self._is_writer:
            params = self._params_io[0]() if self._params_io else None
            save_run_state(state, self.bcd_cfg, self.run_cfg.ckpt_dir,
                           params=params, keep=self.run_cfg.keep,
                           coordinator=self._coord)
        else:
            # readers advance only once the writer's commit is durable —
            # no rank ever runs ahead of restorable state
            checkpoint.wait_for_step(self.run_cfg.ckpt_dir, state.step,
                                     timeout_s=self.run_cfg.wait_timeout_s)
        _maybe_kill_for_test()

    def run(self, init_masks: M.MaskTree) -> bcd_lib.BCDResult:
        """Run (or resume) to completion; returns the usual BCDResult.

        With ``max_steps`` set, the loop may stop before reaching b_target:
        ``stopped_early`` is True and the returned result holds the partial
        state (budget check is skipped — the next invocation picks up the
        checkpoint).
        """
        state = self._restore_or_init(init_masks)
        self.stopped_early = False
        if self.bcd_cfg.b_target >= state.b_ref:
            return bcd_lib.BCDResult(state.masks, state.history, [],
                                     state.move_stats)
        done_now = 0
        since_ckpt = 0
        for _log in bcd_lib.bcd_steps(
                state, self.bcd_cfg, self._eval_acc, self._finetune,
                evaluator=self._evaluator, verbose=self.run_cfg.verbose):
            done_now += 1
            since_ckpt += 1
            if since_ckpt >= self.run_cfg.checkpoint_every:
                self._checkpoint(state)
                since_ckpt = 0
            if self.run_cfg.max_steps is not None and \
                    done_now >= self.run_cfg.max_steps and \
                    M.relu_cost(state.masks) > self.bcd_cfg.b_target:
                self.stopped_early = True
                break
        if since_ckpt:
            self._checkpoint(state)
        if not self.stopped_early:
            bcd_lib.check_reached_target(state, self.bcd_cfg)
        return bcd_lib.BCDResult(state.masks, state.history, state.snapshots,
                                 state.move_stats)
