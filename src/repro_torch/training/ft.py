"""Fault tolerance: restart supervisor and straggler watchdog.

Counterpart of ``repro/training/ft.py``.  The supervisor wraps a training
loop on one host; a node failure surfaces as an exception and the loop
restarts from the newest *valid* checkpoint (``training.checkpoint``, the
reference's on-disk format).  Failures are injected
(:class:`FailureInjector`) so that the whole recovery path runs in tests
and drills:

  run_supervised(...)   — restart-from-checkpoint loop (bounded failures)
  StragglerWatchdog     — per-step wall-time EWMA; flags slow steps

A sharded run (``state_shardings``, a ``launch.mesh.Shardings`` of the
train state's held layout) runs the loop on every rank of the mesh: rank 0
writes each checkpoint, gathered whole (``checkpoint.save(shardings=)``),
and a (re)start restores each rank's shards from the newest one, whatever
mesh wrote it (``checkpoint.restore(shardings=)``).  An injected failure
fires at the same step on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from . import checkpoint


class SimulatedNodeFailure(RuntimeError):
    """Injected stand-in for a node failure (tests / drills only)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedNodeFailure at the given global steps (once each)."""
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        """Raise SimulatedNodeFailure when ``step`` is scheduled to fail."""
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedNodeFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA straggler detection: a step slower than ``slow_factor`` times
    the running mean of the steps before it (after ``warmup`` steps) is
    flagged, and does not enter the mean."""
    alpha: float = 0.1
    slow_factor: float = 2.0
    warmup: int = 3
    ewma: Optional[float] = None
    n: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record one step's wall time; True iff it was flagged as slow."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = self.n > self.warmup and dt > self.slow_factor * self.ewma
        if is_slow:
            self.flagged.append(step)
        else:
            # stragglers do not poison the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow


def run_supervised(
    init_state_fn: Callable[[], object],
    step_fn: Callable[[object, int], object],
    *,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_failures: int = 10,
    injector: Optional[FailureInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    state_shardings=None,
    device="cuda",
) -> Dict:
    """Training loop with checkpoint/restart.  ``step_fn(state, step) ->
    state``.  A (re)start restores the newest valid checkpoint of
    ``ckpt_dir`` into ``init_state_fn()``'s structure, its leaves on
    ``device``, or starts from ``init_state_fn()`` when there is none; a
    checkpoint is written after every ``ckpt_every``-th step and after the
    last.  ``state_shardings``: the state is sharded over a mesh (see the
    module's docstring); ``init_state_fn()`` returns this rank's shards.

    Returns {state, restarts, flagged_steps, completed_steps}.
    """
    restarts = 0
    while True:
        # ---- (re)start: newest valid checkpoint, else fresh init
        start = 0
        state = None
        latest = checkpoint.latest_step(ckpt_dir)
        if latest is not None and checkpoint.validate(ckpt_dir, latest):
            template = init_state_fn()
            state, start = checkpoint.restore(template, ckpt_dir, latest,
                                              shardings=state_shardings,
                                              device=device)
            del template
        if state is None:
            state = init_state_fn()
        try:
            for step in range(start, n_steps):
                t0 = time.perf_counter()
                if injector is not None:
                    injector.check(step)
                state = step_fn(state, step)
                if watchdog is not None:
                    watchdog.observe(step, time.perf_counter() - t0)
                if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
                    checkpoint.save(state, ckpt_dir, step + 1,
                                    shardings=state_shardings)
            return {"state": state, "restarts": restarts,
                    "flagged_steps": (watchdog.flagged if watchdog else []),
                    "completed_steps": n_steps}
        except SimulatedNodeFailure:
            restarts += 1
            if restarts > max_failures:
                raise
