"""Process-role coordination for multi-host runs and sweeps.

Counterpart of ``repro/launch/coordinator.py``, which is pure Python: this is
a copy, with the same classes and the same ``REPRO_COORD_*`` environment
contract, so that the port imports nothing of the JAX package.

A cluster run executes the same deterministic BCD loop on every process
(mask updates are host-side and replicated), but exactly ONE process may
own the checkpoint directory — concurrent writers would interleave two
checkpoint lineages and break the bit-identical-resume contract.  A
:class:`Coordinator` names that owner and gives every rank the three
primitives the runner/sweep layers need:

    rank / world_size    this process's position in the job
    is_writer            rank 0 — the only rank allowed to commit checkpoints
    barrier(tag)         all ranks reach the same named point
    broadcast(tag, x)    writer publishes a small JSON payload; all ranks
                         return it (e.g. the resume step + manifest
                         fingerprint, so every rank restores the SAME
                         checkpoint and can prove it)

Two backends:

- :class:`LocalCoordinator` — the in-process default: rank 0 of 1, barriers
  and broadcasts are no-ops.  Single-process runs pay nothing.
- :class:`FileCoordinator` — ranks rendezvous through a shared filesystem
  directory (the same substrate the checkpoints already require).  Works
  across processes and hosts, and is testable with plain ``subprocess``
  workers.

Every barrier/broadcast *tag* is namespaced by a per-tag use counter, so the
same tag may be reused (e.g. one barrier per sweep stage in a loop) as long
as all ranks issue the same sequence of calls — which the deterministic
run/sweep loops guarantee.  A *session* string namespaces one launch attempt:
after a crash, the relauncher starts all ranks with a fresh session so
leftover rendezvous files from the dead attempt cannot satisfy (or deadlock)
the new one.  Checkpoint directories deliberately live OUTSIDE the session
namespace — they are the state that survives attempts.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

# Environment contract for subprocess/cluster launchers (torchrun-style):
# the launcher exports these for every worker it spawns and `from_env()`
# rebuilds the coordinator from them.
ENV_RANK = "REPRO_COORD_RANK"
ENV_WORLD = "REPRO_COORD_WORLD"
ENV_DIR = "REPRO_COORD_DIR"
ENV_SESSION = "REPRO_COORD_SESSION"
ENV_TIMEOUT = "REPRO_COORD_TIMEOUT_S"   # optional: default rendezvous
#                                         timeout (raise it when slow
#                                         per-stage work keeps one rank
#                                         away from a barrier for minutes)


class CoordinatorError(RuntimeError):
    """A rendezvous failed: a barrier/broadcast timed out (dead or wedged
    peer rank) or the coordinator was constructed inconsistently."""


class LocalCoordinator:
    """Single-process coordinator: rank 0 of 1, all primitives trivial.

    This is the implicit default everywhere a ``coordinator=None`` argument
    is accepted — single-process runs never touch the filesystem or block.
    """

    rank = 0
    world_size = 1

    @property
    def is_writer(self) -> bool:
        """True — a world of one is its own writer."""
        return True

    def barrier(self, tag: str, timeout_s: Optional[float] = None) -> None:
        """No-op: every rank (of one) is already here."""

    def broadcast(self, tag: str, payload=None):
        """Return ``payload`` unchanged (the writer is the only reader)."""
        return payload

    def describe(self) -> dict:
        """JSON-able identity of this coordinator (for checkpoint meta)."""
        return {"backend": "local", "rank": 0, "world_size": 1}

    def close(self) -> None:
        """No-op (kept for interface symmetry with FileCoordinator)."""


class FileCoordinator:
    """File-based rendezvous over a shared directory.

    ``root`` must be visible to every rank (shared filesystem — the same
    requirement the checkpoint directory already imposes).  All rendezvous
    state lives under ``root/<session>/``; relaunch with a fresh ``session``
    after a crash so stale files from the dead attempt are inert.

    Rendezvous files are written atomically (tmp + rename), so a reader
    never sees a partial payload; barriers poll for the arrival files of all
    ``world_size`` ranks and report exactly which ranks are missing when the
    timeout expires — a SIGKILLed peer surfaces as a named
    :class:`CoordinatorError`, not a silent hang.

    **Liveness**: every rank refreshes a per-rank lease file
    (``lease_rank_<r>``, every ``lease_interval_s``) while it waits inside
    ``barrier``/``broadcast``.  When a wait times out, each missing rank's
    lease distinguishes *dead* (lease expired — the process was SIGKILLed
    or the host vanished) from *wedged* (lease fresh — alive but stuck
    elsewhere, e.g. a divergent call sequence) from *never started* (no
    lease at all).  Lease age uses the shared filesystem's mtime, so
    cross-host clock skew cannot mis-declare a peer dead.
    """

    def __init__(self, root: str, rank: int, world_size: int, *,
                 session: str = "s0", poll_s: float = 0.02,
                 timeout_s: float = 300.0, lease_interval_s: float = 1.0,
                 lease_ttl_s: float = 5.0):
        """Join rendezvous directory ``root/<session>`` as ``rank``.

        ``timeout_s`` bounds every barrier/broadcast wait (overridable per
        call); ``poll_s`` is the filesystem polling interval.
        ``lease_interval_s`` is the heartbeat refresh period while waiting;
        a peer whose lease is older than ``lease_ttl_s`` at timeout is
        reported dead (keep ttl comfortably above the interval — a slow
        shared filesystem delays renames).
        """
        if not (0 <= rank < world_size):
            raise CoordinatorError(
                f"rank {rank} outside world of size {world_size}")
        if lease_ttl_s <= lease_interval_s:
            raise CoordinatorError(
                f"lease_ttl_s {lease_ttl_s} must exceed lease_interval_s "
                f"{lease_interval_s} or every slow heartbeat reads as a "
                "death")
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.session = str(session)
        self._dir = os.path.join(root, self.session)
        self._poll_s = float(poll_s)
        self._timeout_s = float(timeout_s)
        self._lease_interval_s = float(lease_interval_s)
        self._lease_ttl_s = float(lease_ttl_s)
        self._lease_at = -float("inf")
        self._seq: dict = {}
        os.makedirs(self._dir, exist_ok=True)
        self._refresh_lease()

    # ------------------------------------------------------------- leases

    def _lease_path(self, rank: int) -> str:
        return os.path.join(self._dir, f"lease_rank_{rank:05d}")

    def _refresh_lease(self) -> None:
        """Touch this rank's lease (atomic, at most once per interval)."""
        now = time.monotonic()
        if now - self._lease_at < self._lease_interval_s:
            return
        mine = self._lease_path(self.rank)
        with open(mine + ".tmp", "w") as f:
            f.write(str(time.time()))
        os.replace(mine + ".tmp", mine)
        self._lease_at = now

    def _peer_status(self, rank: int) -> str:
        """Human-readable liveness verdict for one missing rank."""
        try:
            age = time.time() - os.path.getmtime(self._lease_path(rank))
        except OSError:
            return f"rank {rank} never started (no lease)"
        if age > self._lease_ttl_s:
            return (f"rank {rank} dead (lease expired "
                    f"{age - self._lease_ttl_s:.1f}s ago)")
        return (f"rank {rank} alive (lease {age:.1f}s old) but not here — "
                "wedged or on a divergent call sequence?")

    @property
    def is_writer(self) -> bool:
        """True on rank 0 — the single rank allowed to commit checkpoints."""
        return self.rank == 0

    def _next(self, kind: str, tag: str) -> str:
        key = (kind, tag)
        n = self._seq.get(key, 0)
        self._seq[key] = n + 1
        return f"{kind}_{tag}.{n:04d}"

    def barrier(self, tag: str, timeout_s: Optional[float] = None) -> None:
        """Block until all ``world_size`` ranks reach this barrier.

        Ranks must issue the same sequence of ``barrier``/``broadcast``
        calls (tags are use-counted).  Raises :class:`CoordinatorError`
        naming the missing ranks if the wait exceeds the timeout.
        """
        d = os.path.join(self._dir, self._next("barrier", tag))
        os.makedirs(d, exist_ok=True)
        mine = os.path.join(d, f"rank_{self.rank:05d}")
        with open(mine + ".tmp", "w") as f:
            f.write(str(time.time()))
        os.replace(mine + ".tmp", mine)
        deadline = time.monotonic() + (self._timeout_s if timeout_s is None
                                       else timeout_s)
        want = {f"rank_{r:05d}" for r in range(self.world_size)}
        while True:
            self._refresh_lease()
            have = {p for p in os.listdir(d) if not p.endswith(".tmp")}
            if want <= have:
                return
            if time.monotonic() > deadline:
                missing = sorted(int(p.split("_")[1]) for p in want - have)
                verdicts = "; ".join(self._peer_status(r) for r in missing)
                raise CoordinatorError(
                    f"barrier {tag!r} (session {self.session}) timed out "
                    f"waiting for rank(s) {missing}: {verdicts} — "
                    "relaunch all ranks with a fresh session")
            time.sleep(self._poll_s)

    def broadcast(self, tag: str, payload=None,
                  timeout_s: Optional[float] = None):
        """Writer publishes ``payload`` (JSON-able); every rank returns it.

        Non-writer ranks ignore their ``payload`` argument and block until
        the writer's file lands (atomic rename, so a read never sees a
        partial payload).  Raises :class:`CoordinatorError` on timeout.
        """
        path = os.path.join(self._dir, self._next("bcast", tag) + ".json")
        if self.is_writer:
            with open(path + ".tmp", "w") as f:
                json.dump({"payload": payload}, f)
            os.replace(path + ".tmp", path)
            return payload
        deadline = time.monotonic() + (self._timeout_s if timeout_s is None
                                       else timeout_s)
        while not os.path.exists(path):
            self._refresh_lease()
            if time.monotonic() > deadline:
                raise CoordinatorError(
                    f"broadcast {tag!r} (session {self.session}): rank "
                    f"{self.rank} timed out waiting for the writer — "
                    f"{self._peer_status(0)}; relaunch with a fresh "
                    "session")
            time.sleep(self._poll_s)
        with open(path) as f:
            return json.load(f)["payload"]

    def describe(self) -> dict:
        """JSON-able identity of this coordinator (for checkpoint meta)."""
        return {"backend": "file", "rank": self.rank,
                "world_size": self.world_size, "session": self.session}

    def close(self) -> None:
        """Release nothing actively; rendezvous files are left for the
        launcher to clean (they are inert once the session ends)."""


def from_env(default_root: Optional[str] = None):
    """Build a coordinator from the launcher's environment.

    Reads ``REPRO_COORD_RANK`` / ``REPRO_COORD_WORLD`` /
    ``REPRO_COORD_DIR`` / ``REPRO_COORD_SESSION``; with the world env var
    absent (or world 1), a :class:`LocalCoordinator` is returned, so
    single-process invocations of multi-host-capable entry points need no
    configuration.  For a real multi-rank job, rank AND a fresh-per-attempt
    session are mandatory; ``default_root`` supplies the rendezvous
    directory when the launcher set the rank/world but no
    ``REPRO_COORD_DIR`` (e.g. an out-dir-relative default).
    """
    def _int_env(var: str, value: str) -> int:
        try:
            return int(value)
        except ValueError as e:
            raise CoordinatorError(
                f"{var}={value!r} is not an integer") from e

    world = _int_env(ENV_WORLD, os.environ.get(ENV_WORLD, "1"))
    if world <= 1:
        return LocalCoordinator()
    rank = os.environ.get(ENV_RANK)
    if rank is None:
        raise CoordinatorError(
            f"{ENV_WORLD}={world} but {ENV_RANK} is unset — the launcher "
            "must export a rank for every worker")
    root = os.environ.get(ENV_DIR, default_root)
    if root is None:
        raise CoordinatorError(
            f"{ENV_WORLD}={world} but no rendezvous directory: set "
            f"{ENV_DIR} (a shared filesystem path) or pass default_root")
    session = os.environ.get(ENV_SESSION)
    if session is None:
        # a silent constant default would let a relaunch rendezvous against
        # a dead attempt's leftover files — the exact failure sessions exist
        # to prevent.  The launcher must mint a fresh value per attempt
        # (and the SAME value on every rank of that attempt).
        raise CoordinatorError(
            f"{ENV_WORLD}={world} but {ENV_SESSION} is unset — the launcher "
            "must export a fresh session id per launch attempt, identical "
            "across ranks (e.g. a timestamp or scheduler attempt id)")
    try:
        timeout_s = float(os.environ.get(ENV_TIMEOUT, "300"))
    except ValueError as e:
        raise CoordinatorError(
            f"{ENV_TIMEOUT}={os.environ[ENV_TIMEOUT]!r} is not a "
            "number") from e
    return FileCoordinator(root, _int_env(ENV_RANK, rank), world,
                           session=session, timeout_s=timeout_s)
