"""Continuous-batching serve loop with per-request ReLU-budget SLOs.

Counterpart of ``repro/launch/serve_loop.py``, on one device or over a
``("data", "model")`` mesh of ranks (``ServeLoop(mesh=)``).

The deployment story of the paper: ReLU count ≈ Private-Inference latency,
so a served request's *price* is set by the mask set it runs under.  This
loop serves several ReLU budgets from ONE resident parameter set
(``training.serve.MaskSetStore``), routing each request to a budget by its
SLO class, with:

- **deadline-aware admission** — per-class bounded queues ordered
  earliest-deadline-first; each candidate admission is priced against a
  per-request latency estimate (PI protocol cost seeding measured
  prefill/decode EWMAs) and resolved into an explicit decision:
  **admit**, **degrade** (route to the next-cheaper mask set on a declared
  :class:`DegradationLadder`), or **shed** (reject with a reason *before*
  wasting prefill).  Expired requests are cancelled un-billed;
- **prefill/decode disaggregation** — prefill runs as its own B=1 call,
  then the fresh cache is copied into one slot of the resident per-class
  decode cache (``training.serve.make_insert_slot``), so long prompts never
  stall other streams' decode steps;
- **continuous batching** — each class's lane decodes all live slots every
  tick with a per-slot ``(B,)`` ``cache_len`` (ragged decode: every slot
  sits at its own sequence position); finished slots free up and the queue
  refills them mid-stream;
- **fault tolerance** — a seedable
  :class:`repro_torch.launch.faults.FaultPlan` injects failures at named
  crosspoints (failed/slow prefill, decode stall, corrupted mask-set
  fingerprint); per-crosspoint
  :class:`repro_torch.launch.faults.RetryPolicy` bounds mean every injected
  fault is retried to success, degraded, or shed — never a hung loop, and
  never an unbilled completion.  A fault fires before the prefill it
  fails, so a failed attempt leaves the lane's cache as it was;
- **request-level PI billing** — on completion each request is billed via
  :func:`repro_torch.core.pi_cost.bill_request` applied to the mask set it
  was *actually* served under (fingerprint + any ``degraded_from``
  provenance stamped into the bill for audit).

Mask-set hot-swap copies nothing: mask trees are arguments, views of the
store's resident stack.

Determinism: pass ``clock=faults.VirtualClock()`` and every timestamp is
derived from the PI cost model instead of the host — the same seed and
fault plan replay identical admit/degrade/shed decisions bit-for-bit
(``decision_log`` records them; ``decisions_fingerprint`` hashes them),
on the card and on the CPU alike.

Quickstart (synthetic budgets)::

    PYTHONPATH=src python -m repro_torch.launch.serve_loop \\
        --arch stablelm_1p6b --reduced --requests 8 --budget-fracs 1.0,0.5
"""
from __future__ import annotations

import argparse
import dataclasses
import heapq
import json
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import linearize, masks as M, pi_cost, spmd
from repro_torch.launch import faults as faults_lib
from repro_torch.models.lm import LM
from repro_torch.training import serve as serve_lib

#: Block kinds whose caches carry recurrent state (exact-length prefill
#: required — see ServeLoop's ``prompt_bucket`` docstring).
_RECURRENT_KINDS = frozenset({"mamba", "rwkv"})


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service tier: which mask set (ReLU budget) serves it.

    ``max_new_tokens`` is the tier's generation cap — a premium tier can
    pair a high ReLU budget with longer generations, an economy tier the
    reverse.  ``deadline_ms`` is the tier's end-to-end latency budget per
    request (arrival → last token); ``None`` means best-effort (never
    degraded or shed on time grounds).  ``priority`` breaks ties between
    equal deadlines during admission (higher admits first).
    """

    name: str
    mask_set: str
    max_new_tokens: int = 16
    deadline_ms: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class DegradationLadder:
    """Declared order of mask sets to fall back through under pressure.

    ``rungs`` are mask-set names at strictly descending billable ReLU
    cost — the sweep's stage outputs ARE this ladder (each checkpointed
    budget has a known PI cost and a known accuracy).  A request that
    cannot meet its deadline (or whose lane faulted) is re-routed to the
    first cheaper rung that fits instead of being rejected.
    """

    rungs: Tuple[str, ...]

    def validate(self, store: serve_lib.MaskSetStore) -> None:
        """Every rung stored, costs strictly descending — else ValueError."""
        missing = [r for r in self.rungs if r not in store.names]
        if missing:
            raise ValueError(
                f"ladder rung(s) {missing} not in the mask-set store "
                f"({store.names})")
        costs = [store.info(r).relu_cost for r in self.rungs]
        if any(a <= b for a, b in zip(costs, costs[1:])):
            raise ValueError(
                f"ladder rungs must have strictly descending ReLU cost, "
                f"got {dict(zip(self.rungs, costs))}")

    def below(self, store: serve_lib.MaskSetStore,
              mask_set: str) -> Tuple[str, ...]:
        """Rungs strictly cheaper than ``mask_set``, costliest first."""
        cost = store.info(mask_set).relu_cost
        return tuple(r for r in self.rungs
                     if store.info(r).relu_cost < cost)

    @classmethod
    def from_store(cls, store: serve_lib.MaskSetStore) -> "DegradationLadder":
        """All stored sets ordered by descending billable ReLU cost."""
        rungs = sorted(store.names,
                       key=lambda n: -store.info(n).relu_cost)
        return cls(tuple(rungs))


@dataclasses.dataclass
class Request:
    """One inference request and its measured + billed lifecycle.

    ``state`` walks queued → live → served | degraded, or terminates
    early as shed (with ``shed_reason``) or cancelled.  ``degraded_from``
    records the mask set the SLO class originally routed to when the
    admission controller moved the request down the ladder.
    """

    rid: int
    slo: str
    prompt: np.ndarray
    max_new: int = 1
    deadline_s: Optional[float] = None
    priority: int = 0
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    mask_set: str = ""
    mask_fingerprint: str = ""
    degraded_from: Optional[str] = None
    state: str = "queued"
    shed_reason: str = ""
    bill: Optional[dict] = None
    cancelled: bool = False
    logits: Optional[list] = None    # (V,) rows, when the loop keeps them

    @property
    def queue_s(self) -> float:
        """Seconds spent waiting in the admission queue."""
        return self.t_admit - self.t_arrival

    @property
    def prefill_s(self) -> float:
        """Seconds from admission to first token (prefill + slot insert)."""
        return self.t_first - self.t_admit

    @property
    def decode_s(self) -> float:
        """Seconds spent in the decode stream after the first token."""
        return self.t_done - self.t_first

    @property
    def total_s(self) -> float:
        """End-to-end seconds from arrival to completion."""
        return self.t_done - self.t_arrival

    @property
    def deadline_hit(self) -> bool:
        """Completed, and within the deadline (trivially true without one)."""
        if self.state not in ("served", "degraded"):
            return False
        return self.deadline_s is None or self.t_done <= self.deadline_s

    def _key(self):
        """EDF heap key: earliest deadline, then priority, then arrival."""
        d = math.inf if self.deadline_s is None else self.deadline_s
        return (d, -self.priority, self.rid)


class _Lane:
    """One SLO class's decode lane: resident cache + slot bookkeeping."""

    def __init__(self, slo: SLOClass, cache, slots: int):
        self.slo = slo
        self.cache = cache
        self.heap: list = []           # (edf_key, Request)
        self.live = np.zeros((slots,), bool)
        self.cache_len = np.zeros((slots,), np.int32)
        self.tok = np.zeros((slots,), np.int32)
        self.reqs: List[Optional[Request]] = [None] * slots

    def push(self, req: Request) -> None:
        heapq.heappush(self.heap, (req._key(), req))

    def pop(self) -> Request:
        return heapq.heappop(self.heap)[1]


class _LatencyModel:
    """Per-mask-set EWMAs of per-token prefill/decode seconds.

    Seeded from the PI protocol cost model (the paper's ReLU ≈ latency
    claim gives every budget a price before any request has run), then
    refined with measured latencies as requests complete — the admission
    controller prices candidate admissions against these estimates.
    """

    def __init__(self, store: serve_lib.MaskSetStore,
                 proto: pi_cost.PIProtocol, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.prefill_tok_s: Dict[str, float] = {}
        self.decode_tok_s: Dict[str, float] = {}
        for name in store.names:
            per = store.pi_cost_per_token(name, proto).online_latency_s
            self.prefill_tok_s[name] = per
            self.decode_tok_s[name] = per

    def _ewma(self, table: Dict[str, float], name: str, value: float):
        table[name] += self.alpha * (float(value) - table[name])

    def observe_prefill(self, name: str, seconds: float, tokens: int):
        """Fold one measured prefill (``tokens`` prompt positions)."""
        if tokens > 0 and seconds > 0:
            self._ewma(self.prefill_tok_s, name, seconds / tokens)

    def observe_decode(self, name: str, seconds: float, tokens: int):
        """Fold one request's measured decode tail (``tokens`` generated)."""
        if tokens > 0 and seconds > 0:
            self._ewma(self.decode_tok_s, name, seconds / tokens)

    def estimate_s(self, name: str, prompt_tokens: int,
                   gen_tokens: int) -> float:
        """Remaining-latency estimate for one request under set ``name``."""
        return self.prefill_tok_s[name] * prompt_tokens \
            + self.decode_tok_s[name] * gen_tokens


class ServeLoop:
    """Continuous-batching scheduler over one model + one MaskSetStore.

    ``slots`` decode slots per SLO class; ``max_len`` bounds
    prompt + generation per slot.  ``prompt_bucket`` pads prompts up to a
    multiple of the bucket before the B=1 prefill so a handful of prefill
    shapes serve every prompt length (exact for attention caches:
    causality keeps pad positions out of real tokens' outputs, and the
    pad rows' K/V are hidden from decode by per-slot validity masking;
    recurrent-state models — any ``mamba``/``rwkv`` block — carry their
    state *through* pad positions, so bucketing corrupts it: construction
    fails loudly unless ``prompt_bucket=None`` — exact-length prefill).
    ``mesh``: optional, a ``("data", "model")`` mesh
    (``launch.mesh.make_host_mesh``); every rank of it runs this loop on
    the same requests and makes the same host decisions.  ``params`` are
    then the rank's held shards (``training.serve.shard_params``), each
    lane's slots split over ``"data"`` where they divide, the model
    tensor-parallel over ``"model"``; the B=1 prefill runs on every data
    rank alike and only the rank that holds the slot keeps its cache, and
    each decode tick gathers the lane's tokens over ``"data"``
    (``training.serve.jit_decode_step``).  ``device``: where the caches
    live and the steps run (the card unless the caller asks for the CPU);
    the parameters and the store must live there too.  ``keep_logits``:
    every request keeps the last-position logits of its prefill and of each
    decode tick (``Request.logits``, on ``device``; whole logits on a
    mesh) — for checking the cached path against an uncached forward.

    Overload/fault knobs (all default to the fair-weather behavior):

    - ``ladder``: a :class:`DegradationLadder`; requests that cannot meet
      their deadline (or hit unrecoverable faults) are re-routed to the
      first cheaper rung served by some lane, instead of shed.
    - ``queue_cap``: bound per-class admission queues; arrivals beyond it
      are shed immediately with reason ``queue_full`` (backpressure beats
      unbounded latency).
    - ``clock``: a :class:`repro_torch.launch.faults.VirtualClock` makes every
      timestamp model-derived and every decision reproducible; ``None``
      uses the host clock.
    - ``fault_plan`` / ``retries``: a
      :class:`repro_torch.launch.faults.FaultPlan` injected at the named
      crosspoints, with per-crosspoint
      :class:`repro_torch.launch.faults.RetryPolicy` bounds.
    - ``proto``: the :class:`repro_torch.core.pi_cost.PIProtocol` pricing
      estimates and (under a virtual clock) elapsing time.
    """

    def __init__(self, model: LM, params, store: serve_lib.MaskSetStore,
                 classes: Sequence[SLOClass], *, slots: int = 4,
                 max_len: int = 64, prompt_bucket: Optional[int] = 16,
                 mesh=None, ladder: Optional[DegradationLadder] = None,
                 queue_cap: Optional[int] = None,
                 clock: Optional[faults_lib.VirtualClock] = None,
                 fault_plan: Optional[faults_lib.FaultPlan] = None,
                 retries: Optional[Dict[str, faults_lib.RetryPolicy]] = None,
                 proto: pi_cost.PIProtocol = pi_cost.PIProtocol(),
                 device="cuda", keep_logits: bool = False):
        """Build lanes (one resident decode cache per SLO class)."""
        if not classes:
            raise ValueError("ServeLoop needs at least one SLO class")
        for c in classes:
            if c.mask_set not in store.names:
                raise serve_lib.MaskSetError(
                    f"SLO class {c.name!r} routes to mask set "
                    f"{c.mask_set!r}, not in the store ({store.names})")
        kinds = {b.kind for b in (tuple(model.cfg.head_blocks)
                                  + tuple(model.cfg.pattern)
                                  + tuple(model.cfg.tail))}
        recurrent = sorted(kinds & _RECURRENT_KINDS)
        if recurrent and prompt_bucket is not None:
            raise ValueError(
                f"model {model.cfg.name!r} has recurrent-state block(s) "
                f"{recurrent}: their caches carry state through padded "
                f"prompt positions, so bucketed prefill "
                f"(prompt_bucket={prompt_bucket}) would corrupt every "
                "stream in the lane.  Construct the ServeLoop with "
                "prompt_bucket=None (exact-length prefill).")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if ladder is not None:
            ladder.validate(store)
        self.model, self.params, self.store = model, params, store
        self.slots, self.max_len = slots, max_len
        self.prompt_bucket = prompt_bucket
        self.ladder = ladder
        self.queue_cap = queue_cap
        self.clock = clock
        self.proto = proto
        self.fault_plan = fault_plan
        self.retries = dict(faults_lib.DEFAULT_RETRIES)
        if retries:
            self.retries.update(retries)
        self.device = torch.device(device)
        self.keep_logits = keep_logits
        self.mesh = mesh
        tpm = model.on_mesh(mesh)
        self._tpm = tpm
        self._prefill = _make_last_logit_prefill(tpm)
        self._insert = serve_lib.make_insert_slot(model)
        self._decode = serve_lib.jit_decode_step(
            model, mesh, serve_lib.ServeCfg(max_len=max_len, batch=slots))
        # the slots this rank's lane caches hold: [lo, hi)
        dax = tpm.data_axis
        self._slot_span = dax.span(slots) \
            if dax.size > 1 and slots % dax.size == 0 else (0, slots)
        # one B=1 prefill cache, zeroed before every prefill (a recurrent
        # state must start from zeros) and only ever copied from
        self._small = tpm.init_cache(1, max_len, self.device)
        # lanes never share a cache tensor
        self.lanes: Dict[str, _Lane] = {
            c.name: _Lane(c, tpm.init_cache(slots, max_len, self.device),
                          slots)
            for c in classes}
        # host-side: which sets carry share ties (binary ones skip the
        # tie override, as the engines do)
        self._ties = {n: linearize.has_share_ties(store.host(n))
                      for n in store.names}
        # degrade routing: the first lane serving each mask set
        self._lane_for_set: Dict[str, str] = {}
        for c in classes:
            self._lane_for_set.setdefault(c.mask_set, c.name)
        self.latency = _LatencyModel(store, proto)
        # virtual-time cost basis: fixed per set, so clocks replay exactly
        self._virtual_tok_s = {
            name: store.pi_cost_per_token(name, proto).online_latency_s
            for name in store.names}
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.decision_log: List[dict] = []
        self.fault_stats: Dict[str, Dict[str, int]] = {}
        self._next_rid = 0
        self._accepting = True

    # ------------------------------------------------------------- clock

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.perf_counter()

    def _elapse(self, seconds: float) -> None:
        """Advance virtual time (no-op on the host clock — it advances
        itself)."""
        if self.clock is not None and seconds > 0:
            self.clock.advance(seconds)

    # ------------------------------------------------------------ faults

    def _draw(self, crosspoint: str) -> Optional[faults_lib.FaultSpec]:
        if self.fault_plan is None:
            return None
        return self.fault_plan.draw(crosspoint)

    def _count(self, crosspoint: str, outcome: str) -> None:
        per = self.fault_stats.setdefault(
            crosspoint, {"injected": 0, "retried": 0, "gave_up": 0})
        per[outcome] += 1

    def _policy(self, crosspoint: str) -> faults_lib.RetryPolicy:
        return self.retries.get(crosspoint, faults_lib.RetryPolicy())

    # ------------------------------------------------------------ intake

    def submit(self, prompt: np.ndarray, slo: str) -> Request:
        """Enqueue a prompt under an SLO class; returns its Request.

        With a bounded queue (``queue_cap``) a full class queue sheds the
        arrival immediately (``state == "shed"``, reason ``queue_full``)
        instead of queueing unbounded latency — check ``Request.state``.
        """
        if not self._accepting:
            raise RuntimeError("serve loop is shut down")
        if slo not in self.lanes:
            raise KeyError(f"unknown SLO class {slo!r} "
                           f"(have: {sorted(self.lanes)})")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        lane = self.lanes[slo]
        cap = self.max_len - lane.slo.max_new_tokens
        if not 0 < len(prompt) <= cap:
            raise ValueError(
                f"prompt length {len(prompt)} outside (0, {cap}] "
                f"(max_len {self.max_len} minus the class's "
                f"{lane.slo.max_new_tokens} generation budget)")
        now = self._now()
        deadline = None if lane.slo.deadline_ms is None \
            else now + lane.slo.deadline_ms / 1e3
        req = Request(rid=self._next_rid, slo=slo, prompt=prompt,
                      max_new=lane.slo.max_new_tokens,
                      deadline_s=deadline, priority=lane.slo.priority,
                      t_arrival=now)
        self._next_rid += 1
        if self.queue_cap is not None and len(lane.heap) >= self.queue_cap:
            self._shed(req, "queue_full")
            return req
        lane.push(req)
        return req

    # ------------------------------------------------------------ ticking

    def step(self) -> int:
        """One scheduler tick: admit into free slots, decode every lane.

        Returns the number of requests still in flight (queued + live).
        """
        with torch.no_grad():
            for lane in self.lanes.values():
                self._admit(lane)
            for lane in self.lanes.values():
                self._decode_lane(lane)
        return self.pending()

    def pending(self) -> int:
        """Requests not yet terminal: queued plus occupying a slot."""
        return sum(len(ln.heap) + int(ln.live.sum())
                   for ln in self.lanes.values())

    def run_until_drained(self, max_steps: int = 100000) -> None:
        """Tick until every queue and slot is empty (or ``max_steps``)."""
        for _ in range(max_steps):
            if self.step() == 0:
                return
        raise RuntimeError(
            f"serve loop failed to drain within {max_steps} steps "
            f"({self.pending()} requests still pending)")

    def shutdown(self, drain: bool = True) -> List[Request]:
        """Stop intake; drain in-flight work (or cancel it) and return
        every completed request.

        ``drain=True`` runs the loop until queues and slots are empty —
        every admitted request reaches a terminal state (served, degraded,
        shed, or expired) and only served work is billed.  ``drain=False``
        cancels queued and in-flight requests (marked ``cancelled``, never
        billed) and releases every lane slot, so a fresh loop on the same
        store starts from clean state.
        """
        self._accepting = False
        if drain:
            self.run_until_drained()
        else:
            for lane in self.lanes.values():
                queued = [r for _, r in lane.heap]
                for req in queued + [r for r in lane.reqs if r]:
                    req.cancelled = True
                    req.state = "cancelled"
                lane.heap.clear()
                lane.live[:] = False
                lane.cache_len[:] = 0
                lane.tok[:] = 0
                lane.reqs = [None] * self.slots
        return self.completed

    # ------------------------------------------------------------ decisions

    def _decide(self, req: Request, decision: str, **detail) -> None:
        entry = {"rid": req.rid, "slo": req.slo, "decision": decision}
        entry.update(detail)
        self.decision_log.append(entry)

    def _shed(self, req: Request, reason: str) -> None:
        """Terminal rejection: recorded with a reason, never billed."""
        req.state = "shed"
        req.shed_reason = reason
        self.shed.append(req)
        self._decide(req, "shed", reason=reason)

    def _try_degrade(self, req: Request, lane: _Lane, now: float,
                     reason: str) -> bool:
        """Route ``req`` one or more rungs down the ladder.

        Picks the first strictly-cheaper rung that (a) some lane serves
        and (b) whose latency estimate fits the request's remaining
        deadline budget (any rung, when the request has no deadline).
        Returns False when no rung qualifies — caller sheds.
        """
        if self.ladder is None:
            return False
        current = lane.slo.mask_set
        for rung in self.ladder.below(self.store, current):
            target_name = self._lane_for_set.get(rung)
            if target_name is None:
                continue
            est = self.latency.estimate_s(rung, len(req.prompt), req.max_new)
            if req.deadline_s is not None and now + est > req.deadline_s:
                continue
            if req.degraded_from is None:
                req.degraded_from = current
            self.lanes[target_name].push(req)
            self._decide(req, "degrade", reason=reason,
                         from_set=current, to_set=rung)
            return True
        return False

    # ------------------------------------------------------------ internals

    def _bucket(self, n: int) -> int:
        b = self.prompt_bucket
        return n if not b else min(-(-n // b) * b, self.max_len - 1)

    def _verify_masks(self, lane: _Lane) -> bool:
        """Fingerprint-verify the lane's mask set (fault crosspoint
        ``fingerprint``), retrying per policy; False = unrecoverable."""
        pol = self._policy("fingerprint")
        name = lane.slo.mask_set
        for attempt in range(1, pol.max_attempts + 1):
            fault = self._draw("fingerprint")
            observed = None
            if fault is not None and fault.kind == "corrupt":
                self._count("fingerprint", "injected")
                observed = faults_lib.corrupt_fingerprint(
                    self.store.info(name).fingerprint)
            try:
                self.store.verify(name, observed=observed)
                return True
            except serve_lib.MaskSetError:
                if attempt < pol.max_attempts:
                    self._count("fingerprint", "retried")
                    self._elapse(pol.backoff_s * attempt)
        self._count("fingerprint", "gave_up")
        return False

    def _admit(self, lane: _Lane) -> None:
        """EDF admission for one lane: pop by earliest deadline and decide
        admit / degrade / shed per candidate until slots or queue run out."""
        free = list(np.flatnonzero(~lane.live))
        while lane.heap and free:
            req = lane.pop()
            now = self._now()
            # expired while queued: cancel un-billed before any prefill
            if req.deadline_s is not None and now >= req.deadline_s:
                req.cancelled = True
                self._shed(req, "deadline_expired")
                continue
            est = self.latency.estimate_s(lane.slo.mask_set,
                                          len(req.prompt), req.max_new)
            if req.deadline_s is not None and now + est > req.deadline_s:
                if not self._try_degrade(req, lane, now,
                                         reason="deadline_unmeetable"):
                    self._shed(req, "deadline_unmeetable")
                continue
            if not self._verify_masks(lane):
                if not self._try_degrade(req, lane, self._now(),
                                         reason="mask_corrupt"):
                    self._shed(req, "mask_corrupt")
                continue
            slot = int(free[0])
            if self._prefill_into_slot(lane, slot, req):
                free.pop(0)
                self._decide(req, "admit", set=lane.slo.mask_set,
                             slot=slot)
            else:
                if not self._try_degrade(req, lane, self._now(),
                                         reason="prefill_failed"):
                    self._shed(req, "prefill_failed")

    def _prefill_into_slot(self, lane: _Lane, slot: int,
                           req: Request) -> bool:
        """Run the B=1 prefill and scatter its cache into ``slot``.

        The ``prefill`` fault crosspoint fires per attempt: ``fail``
        faults (and ``slow`` delays beyond the policy timeout) consume an
        attempt with backoff; exhausting the policy returns False and the
        caller degrades or sheds — an injected fault never half-admits.
        """
        pol = self._policy("prefill")
        for attempt in range(1, pol.max_attempts + 1):
            fault = self._draw("prefill")
            if fault is not None:
                self._count("prefill", "injected")
                if fault.kind == "slow" and fault.delay_s <= pol.timeout_s:
                    self._elapse(fault.delay_s)     # absorbed as latency
                else:                               # fail (or timed out)
                    if attempt < pol.max_attempts:
                        self._count("prefill", "retried")
                        self._elapse(pol.backoff_s * attempt)
                        continue
                    self._count("prefill", "gave_up")
                    return False
            req.t_admit = self._now()
            L = len(req.prompt)
            toks = np.zeros((1, self._bucket(L)), np.int32)
            toks[0, :L] = req.prompt
            name = lane.slo.mask_set
            masks = self.store.select(name)
            small = _zero_(self._small)
            nxt, small, last = self._prefill(
                self.params, masks, torch.from_numpy(toks).to(self.device),
                small, L - 1, ties=self._ties[name])
            lo, hi = self._slot_span
            if lo <= slot < hi:
                lane.cache = self._insert(lane.cache, small, slot - lo)
            first = int(nxt[0, 0])
            if self.keep_logits:
                req.logits = [serve_lib.gather_logits(last, self._tpm, 1)[0]]
            self._elapse(self._virtual_tok_s[lane.slo.mask_set] * L)
            req.t_first = self._now()
            self.latency.observe_prefill(lane.slo.mask_set,
                                         req.prefill_s, L)
            req.tokens.append(first)
            info = self.store.info(lane.slo.mask_set)
            req.mask_set, req.mask_fingerprint = info.name, info.fingerprint
            req.state = "live"
            lane.live[slot] = True
            lane.cache_len[slot] = L
            lane.tok[slot] = first
            lane.reqs[slot] = req
            if req.max_new <= 1:
                self._finish(lane, slot)
            return True
        return False

    def _decode_lane(self, lane: _Lane) -> None:
        if not lane.live.any():
            return
        fault = self._draw("decode")
        if fault is not None and fault.kind == "stall":
            # a stalled tick is retried in place: the injected delay lands
            # on every live stream's clock, then the decode step proceeds
            self._count("decode", "injected")
            self._count("decode", "retried")
            self._elapse(fault.delay_s)
        name = lane.slo.mask_set
        masks = self.store.select(name)
        tok = torch.from_numpy(lane.tok[:, None].copy()).to(self.device)
        nxt, lane.cache, logits = self._decode(
            self.params, masks, tok, lane.cache, lane.cache_len,
            ties=self._ties[name])
        nxt = nxt.cpu().numpy().reshape(-1)
        if self.keep_logits:
            logits = serve_lib.gather_logits(logits, self._tpm, self.slots)
        self._elapse(self._virtual_tok_s[lane.slo.mask_set])
        for slot in np.flatnonzero(lane.live):
            req = lane.reqs[slot]
            req.tokens.append(int(nxt[slot]))
            if self.keep_logits:
                req.logits.append(logits[slot])
            lane.tok[slot] = nxt[slot]
            lane.cache_len[slot] += 1
            done = len(req.tokens) >= req.max_new
            if done or lane.cache_len[slot] + 1 >= self.max_len:
                self._finish(lane, slot)

    def _finish(self, lane: _Lane, slot: int) -> None:
        req = lane.reqs[slot]
        req.t_done = self._now()
        gen = len(req.tokens) - 1
        if gen > 0:
            self.latency.observe_decode(lane.slo.mask_set,
                                        req.decode_s, gen)
        info = self.store.info(lane.slo.mask_set)
        req.bill = pi_cost.bill_request(
            info.relu_cost, len(self.store.site_shapes),
            tokens=len(req.prompt) + len(req.tokens), proto=self.proto,
            mask_set=info.name, fingerprint=info.fingerprint,
            degraded_from=req.degraded_from)
        req.state = "degraded" if req.degraded_from else "served"
        lane.live[slot] = False
        lane.reqs[slot] = None
        self.completed.append(req)

    # ------------------------------------------------------------ reporting

    def stats(self) -> dict:
        """Per-SLO-class latency/throughput/billing/robustness aggregates.

        ``decode_tok_s`` is per-slot decode rate (generated tokens over
        in-slot decode seconds, summed per class); percentiles are
        milliseconds over completed requests.  Robustness keys:
        per class ``served``/``degraded``/``shed`` counts,
        ``shed_reasons``, and ``deadline_hit_rate`` (completed within
        deadline over all terminal requests of the class — shed requests
        count as misses); totals add ``goodput_tok_s`` (generated tokens
        of deadline-hitting requests per second of serving span),
        ``degrade_rate``/``shed_rate``, per-crosspoint ``retries``, and
        ``decisions_sha256`` (hash of the ordered admit/degrade/shed log —
        equal hashes == bit-identical scheduling).
        """
        out: dict = {"classes": {}}
        for name, lane in self.lanes.items():
            reqs = [r for r in self.completed if r.slo == name]
            shed = [r for r in self.shed if r.slo == name]
            info = self.store.info(lane.slo.mask_set)
            per_tok = self.store.pi_cost_per_token(lane.slo.mask_set,
                                                   self.proto)
            cls = {"mask_set": lane.slo.mask_set,
                   "relu_cost": info.relu_cost,
                   "mask_fingerprint": info.fingerprint,
                   "pi_online_s_per_tok": per_tok.online_latency_s,
                   "deadline_ms": lane.slo.deadline_ms,
                   "priority": lane.slo.priority,
                   "requests": len(reqs),
                   "served": sum(r.state == "served" for r in reqs),
                   "degraded": sum(r.state == "degraded" for r in reqs),
                   "shed": len(shed),
                   "shed_reasons": _histogram(r.shed_reason for r in shed)}
            terminal = len(reqs) + len(shed)
            if terminal:
                cls["deadline_hit_rate"] = \
                    sum(r.deadline_hit for r in reqs) / terminal
            if reqs:
                gen = sum(len(r.tokens) - 1 for r in reqs)
                dec = sum(r.decode_s for r in reqs)
                cls["decode_tok_s"] = gen / dec if dec > 0 else 0.0
                for key, get in (("queue", lambda r: r.queue_s),
                                 ("prefill", lambda r: r.prefill_s),
                                 ("decode", lambda r: r.decode_s),
                                 ("total", lambda r: r.total_s)):
                    vals = np.array([get(r) for r in reqs]) * 1e3
                    cls[f"{key}_ms_p50"] = float(np.percentile(vals, 50))
                    cls[f"{key}_ms_p95"] = float(np.percentile(vals, 95))
                cls["relus_billed"] = sum(r.bill["relus_billed"]
                                          for r in reqs)
                cls["pi_online_s"] = sum(r.bill["pi_online_s"]
                                         for r in reqs)
            out["classes"][name] = cls
        out["completed"] = len(self.completed)
        out["shed"] = len(self.shed)
        out["terminal"] = len(self.completed) + len(self.shed)
        out["pending"] = self.pending()
        out["degrade_rate"] = _rate(
            sum(r.state == "degraded" for r in self.completed),
            out["terminal"])
        out["shed_rate"] = _rate(len(self.shed), out["terminal"])
        hits = [r for r in self.completed if r.deadline_hit]
        out["deadline_hit_rate"] = _rate(len(hits), out["terminal"])
        span = self._serving_span()
        good = sum(len(r.tokens) - 1 for r in hits)
        out["goodput_tok_s"] = good / span if span > 0 else 0.0
        out["retries"] = {c: dict(v)
                          for c, v in sorted(self.fault_stats.items())}
        out["faults_injected"] = (self.fault_plan.stats()
                                  if self.fault_plan else {})
        out["decisions_sha256"] = decisions_fingerprint(self.decision_log)
        return out

    def _serving_span(self) -> float:
        """Seconds from the first arrival to the last completion."""
        terminal = self.completed + self.shed
        if not self.completed or not terminal:
            return 0.0
        t0 = min(r.t_arrival for r in terminal)
        t1 = max(r.t_done for r in self.completed)
        return t1 - t0


def _histogram(values) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in values:
        out[v] = out.get(v, 0) + 1
    return dict(sorted(out.items()))


def _rate(n: int, total: int) -> float:
    return n / total if total else 0.0


def decisions_fingerprint(decision_log: List[dict]) -> str:
    """sha256 over the ordered decision log — the reproducibility witness
    (equal fingerprints == bit-identical admit/degrade/shed scheduling)."""
    import hashlib
    blob = json.dumps(decision_log, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _zero_(tree):
    """Zero every leaf of a cache tree in place; returns the tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            _zero_(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _zero_(v)
    else:
        tree.zero_()
    return tree


def _make_last_logit_prefill(model: LM):
    """B=1 prefill: argmax logits at the prompt's true last position.

    Prompts arrive right-padded to a bucket length; ``last_idx`` picks the
    real final position.  Returns ``(next token (B, 1) int32, cache, the
    logits there (B, V))``; on a mesh the logits are the rank's block of
    the vocabulary.
    """
    def prefill(params, masks, tokens, cache, last_idx, ties=True):
        logits, cache = model.forward(params, masks, tokens, cache=cache,
                                      cache_len=0, ties=ties)
        last = logits[:, int(last_idx)]
        # on a mesh: the rank's vocabulary block, argmax over the axis
        nxt = spmd.argmax(last, model.model_axis).to(torch.int32)[:, None]
        return nxt, cache, last
    return prefill


def threshold_mask_sets(model: LM, fracs: Sequence[float],
                        seed: int = 0, device="cuda"
                        ) -> serve_lib.MaskSetStore:
    """Synthetic named budgets: one random-priority threshold per keep-frac.

    Serving smoke tests and the load generator use this when no sweep run
    directory is available; real deployments load checkpointed masks via
    :meth:`repro_torch.training.serve.MaskSetStore.from_run_dir`.
    """
    shapes = {k: s.shape for k, s in model.mask_sites().items()}
    full = M.full_masks(shapes)
    total = M.count(full)
    rng = np.random.default_rng(seed)
    soft = {k: rng.random(v.shape).astype(np.float32)
            for k, v in full.items()}
    sets = {f"kf{int(round(f * 100)):03d}": M.threshold(soft,
                                                        int(total * f))
            for f in fracs}
    return serve_lib.MaskSetStore(shapes, sets, device=device)


def default_classes(store: serve_lib.MaskSetStore,
                    max_new_tokens: int = 8,
                    deadline_ms: Optional[Dict[str, float]] = None
                    ) -> List[SLOClass]:
    """One SLO class per stored budget, named after its mask set.

    ``deadline_ms`` optionally assigns per-set deadlines (name → ms).
    """
    deadline_ms = deadline_ms or {}
    return [SLOClass(name=n, mask_set=n, max_new_tokens=max_new_tokens,
                     deadline_ms=deadline_ms.get(n))
            for n in store.names]


def main(argv=None):
    """CLI demo: serve random prompts at ≥2 synthetic budgets and print
    the per-class stats JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1p6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--budget-fracs", default="1.0,0.5",
                    help="comma list of keep-fracs -> synthetic mask sets")
    ap.add_argument("--masks-from", default=None, metavar="RUN_DIR",
                    help="load checkpointed mask sets from a sweep run dir "
                         "instead of synthetic thresholds")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request end-to-end deadline applied to every "
                         "class (default: best-effort, no deadlines)")
    ap.add_argument("--prompt-bucket", type=int, default=16,
                    help="pad prompts to a multiple of this (0: exact "
                         "lengths, which recurrent models need)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen, args.device)
    shapes = {k: s.shape for k, s in model.mask_sites().items()}
    if args.masks_from:
        store = serve_lib.MaskSetStore.from_run_dir(args.masks_from, shapes,
                                                    device=args.device)
    else:
        fracs = [float(x) for x in args.budget_fracs.split(",")]
        store = threshold_mask_sets(model, fracs, seed=args.seed,
                                    device=args.device)
    deadlines = ({n: args.deadline_ms for n in store.names}
                 if args.deadline_ms else None)
    loop = ServeLoop(model, params, store,
                     default_classes(store, args.max_new, deadlines),
                     slots=args.slots, max_len=args.max_len,
                     prompt_bucket=args.prompt_bucket or None,
                     ladder=DegradationLadder.from_store(store),
                     device=args.device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        slo = store.names[i % len(store.names)]
        plen = int(rng.integers(4, args.max_len - args.max_new))
        loop.submit(rng.integers(0, cfg.vocab, plen), slo)
    loop.shutdown(drain=True)
    print(json.dumps(loop.stats(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
