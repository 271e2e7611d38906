"""Deterministic fault injection for the serving tier.

Counterpart of ``repro/launch/faults.py``, copied: pure numpy, no device
work, so the port keeps its own copy (as it does ``core/masks.py``) and the
same ``(specs, seed)`` draws the same faults in both packages.

Overload/failure robustness is only testable if failure is *reproducible*:
a chaos run that sheds different requests every time cannot be gated.
This module gives the serve loop three deterministic primitives:

- :class:`FaultPlan` — a seedable schedule of injected faults at named
  **crosspoints** (``prefill``, ``decode``, ``fingerprint``, ``burst``).
  Each crosspoint owns an independent counter-based RNG stream, so the draw
  sequence at one crosspoint is invariant to how often the others fire;
  the same ``(specs, seed)`` pair replays the exact same fault schedule.
- :class:`RetryPolicy` — per-crosspoint bounded retry with linear backoff
  and an injected-delay timeout, so every injected fault is either retried
  to success, degraded, or shed — never a hung loop.
- :class:`VirtualClock` — a monotonically advancing logical clock the loop
  can substitute for ``time.perf_counter``.  Virtual time advances by the
  *modeled* cost of each operation (the PI protocol's per-token latency),
  making every timestamp — and therefore every deadline-driven
  admit/degrade/shed decision — bit-for-bit reproducible across runs and
  hosts.

``launch.serve_loop.ServeLoop`` takes a :func:`default_chaos_plan`;
``chip_smoke.py``'s chaos drill runs it on the card and on the CPU and
asserts the decision logs are identical.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np

#: The crosspoint names the serve loop injects at.  ``prefill``: the B=1
#: prefill call (kinds: fail, slow); ``decode``: a lane's decode tick
#: (kind: stall); ``fingerprint``: mask-set fingerprint verification at
#: admission (kind: corrupt); ``burst``: load-generator arrival bursts that
#: drive queues to their bound (kind: burst).
CROSSPOINTS = ("prefill", "decode", "fingerprint", "burst")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault: where, what, how often.

    ``rate`` is the per-opportunity injection probability; ``delay_s`` is
    the virtual delay a ``slow``/``stall`` fault adds; ``burst`` is the
    number of extra arrivals a ``burst`` fault injects at once.
    """

    crosspoint: str
    kind: str                  # fail | slow | stall | corrupt | burst
    rate: float
    delay_s: float = 0.0
    burst: int = 0

    def __post_init__(self):
        if self.crosspoint not in CROSSPOINTS:
            raise ValueError(
                f"unknown crosspoint {self.crosspoint!r} "
                f"(have: {CROSSPOINTS})")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")


class FaultError(RuntimeError):
    """An injected fault fired at a crosspoint (carried for retry loops)."""

    def __init__(self, spec: FaultSpec, attempt: int):
        super().__init__(
            f"injected {spec.kind} fault at crosspoint "
            f"{spec.crosspoint!r} (attempt {attempt})")
        self.spec = spec
        self.attempt = attempt


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry for one crosspoint.

    ``max_attempts`` bounds total tries (first try included);
    ``backoff_s`` is added to the clock per failed attempt, scaled
    linearly (attempt 1 waits 1×, attempt 2 waits 2×, …);
    ``timeout_s``: an injected ``slow``/``stall`` delay beyond this is
    treated as a *failed* attempt (the caller timed the call out) rather
    than absorbed as latency.
    """

    max_attempts: int = 3
    backoff_s: float = 0.005
    timeout_s: float = math.inf


#: Per-crosspoint retry defaults used by ServeLoop when none are passed.
DEFAULT_RETRIES: Dict[str, RetryPolicy] = {
    "prefill": RetryPolicy(max_attempts=3, backoff_s=0.005),
    "decode": RetryPolicy(max_attempts=2, backoff_s=0.002),
    "fingerprint": RetryPolicy(max_attempts=2, backoff_s=0.0),
}


class FaultPlan:
    """A deterministic, seedable schedule of faults over crosspoints.

    Each crosspoint draws from its own :func:`numpy.random.default_rng`
    stream seeded by ``(seed, sha256(crosspoint))``, so the schedule at one
    crosspoint does not shift when another crosspoint is consulted more or
    fewer times.  Given the same specs, seed, and per-crosspoint call
    sequence (which the virtual clock makes deterministic), :meth:`draw`
    returns the identical fault sequence on every run.
    """

    def __init__(self, specs: Tuple[FaultSpec, ...], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._by_cross: Dict[str, Tuple[FaultSpec, ...]] = {
            c: tuple(s for s in self.specs if s.crosspoint == c)
            for c in CROSSPOINTS}
        self._rngs = {c: np.random.default_rng(
            [self.seed, _stable_id(c)]) for c in CROSSPOINTS}
        self.injected: Dict[str, Dict[str, int]] = {}

    def draw(self, crosspoint: str) -> Optional[FaultSpec]:
        """One injection opportunity; returns the fault to inject or None.

        Consumes exactly one uniform per spec declared at the crosspoint
        (fixed consumption keeps later draws aligned regardless of which
        faults fired earlier); the first spec whose rate covers its draw
        wins.
        """
        rng = self._rngs[crosspoint]
        hit = None
        for spec in self._by_cross[crosspoint]:
            u = float(rng.random())
            if hit is None and u < spec.rate:
                hit = spec
        if hit is not None:
            per = self.injected.setdefault(crosspoint, {})
            per[hit.kind] = per.get(hit.kind, 0) + 1
        return hit

    def stats(self) -> dict:
        """JSON-ready injected-fault counts per crosspoint and kind."""
        return {c: dict(kinds) for c, kinds in sorted(self.injected.items())}

    def describe(self) -> dict:
        """JSON-ready identity of the plan (for bench report configs)."""
        return {"seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs]}


def _stable_id(name: str) -> int:
    """Process-invariant 32-bit id for a crosspoint name (hash() is salted
    per process, which would break cross-run determinism)."""
    return int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:4], "big")


def default_chaos_plan(seed: int = 0) -> FaultPlan:
    """The committed chaos schedule (the reference's CI ``chaos-smoke``
    schedule).

    Covers every crosspoint: failed and slow prefills, decode stalls,
    corrupted mask-set fingerprints, and queue-filling arrival bursts.
    Rates are chosen so a ~40-request overload run injects several faults
    of each kind while still completing quickly on a CPU runner.
    """
    return FaultPlan((
        FaultSpec("prefill", "fail", rate=0.12),
        FaultSpec("prefill", "slow", rate=0.10, delay_s=0.25),
        FaultSpec("decode", "stall", rate=0.06, delay_s=0.10),
        FaultSpec("fingerprint", "corrupt", rate=0.08),
        FaultSpec("burst", "burst", rate=0.12, burst=3),
    ), seed=seed)


def corrupt_fingerprint(fingerprint: str) -> str:
    """The garbage hash a ``corrupt`` fault makes verification observe
    (deterministic: flips the real digest, so it never accidentally
    matches)."""
    return hashlib.sha256(
        ("corrupt:" + fingerprint).encode()).hexdigest()


class VirtualClock:
    """Deterministic logical clock: ``now()`` returns accumulated seconds.

    The serve loop advances it by the *modeled* cost of each operation
    (PI per-token latency × tokens, injected delays, retry backoff).  With
    every timestamp derived from the model instead of the host, deadline
    arithmetic — and every admit/degrade/shed decision downstream of it —
    replays bit-for-bit under the same seed and fault plan.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        """Current virtual time in seconds."""
        return self._t

    def advance(self, seconds: float) -> float:
        """Move time forward (negative advances are rejected)."""
        if seconds < 0:
            raise ValueError(f"cannot advance time by {seconds}")
        self._t += float(seconds)
        return self._t
