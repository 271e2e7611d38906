"""Private-Inference cost model — why ReLU count is the latency bottleneck.

Counterpart of ``repro/core/pi_cost.py`` (pure Python; a copy).

DELPHI-style hybrid protocol accounting (Srinivasan et al., USENIX Sec'20):
linear layers are evaluated under additive secret sharing with the heavy
lifting moved to an offline phase; each *online* ReLU requires a garbled-
circuit evaluation whose communication dominates.  Constants below follow the
published per-ReLU figures (order-of-magnitude; configurable):

  online  ≈ 2.0 KiB per ReLU  (GC evaluation + share reconstruction)
  offline ≈ 17.5 KiB per ReLU (garbling + OT)

Latency = comm / bandwidth + per-round RTTs + linear-layer share ops.
This module turns a mask budget into the latency/bandwidth savings the paper
claims PI gets from linearization.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PIProtocol:
    name: str = "delphi"
    online_bytes_per_relu: float = 2.0 * 1024
    offline_bytes_per_relu: float = 17.5 * 1024
    bandwidth_bytes_per_s: float = 1e9 / 8      # 1 Gb/s WAN-ish link
    rtt_s: float = 0.010
    rounds_per_layer: int = 2
    linear_online_bytes_per_param: float = 0.0  # linear layers ~free online


@dataclasses.dataclass(frozen=True)
class PICost:
    relus: int
    online_bytes: float
    offline_bytes: float
    online_latency_s: float
    total_bytes: float


def cost(relu_count: int, n_nonlinear_layers: int,
         proto: PIProtocol = PIProtocol(), linear_params: int = 0) -> PICost:
    online = relu_count * proto.online_bytes_per_relu \
        + linear_params * proto.linear_online_bytes_per_param
    offline = relu_count * proto.offline_bytes_per_relu
    latency = online / proto.bandwidth_bytes_per_s \
        + n_nonlinear_layers * proto.rounds_per_layer * proto.rtt_s
    return PICost(relu_count, online, offline, latency, online + offline)


def cost_of_masks(masks, n_nonlinear_layers: int,
                  proto: PIProtocol = PIProtocol(),
                  linear_params: int = 0) -> PICost:
    """:func:`cost` for a mask tree — bills *driver* ReLUs only.

    Before share moves, ``||m||_0 == billable ReLUs``; a share-tied
    coordinate (``masks.TIE``) keeps its gate but reuses its driver's
    garbled-circuit comparison, so the protocol is charged
    ``masks.relu_cost`` (coordinates > 0.9), not ``masks.count``.  The
    reconstruction share for a tied coordinate rides in the driver's
    existing message — no extra bytes, no extra rounds.
    """
    from . import masks as M
    return cost(M.relu_cost(masks), n_nonlinear_layers, proto,
                linear_params)


def bill_request(relu_count: int, n_nonlinear_layers: int, tokens: int,
                 proto: PIProtocol = PIProtocol(),
                 linear_params: int = 0, *,
                 mask_set: str | None = None,
                 fingerprint: str | None = None,
                 degraded_from: str | None = None) -> dict:
    """Per-request PI bill: one token-forward :func:`cost`, scaled by tokens.

    A served request runs ``tokens`` forwards (prompt positions during
    prefill + one per generated token) under one mask set; each forward
    pays the set's per-token protocol cost.  Returns a JSON-ready dict —
    this is the number a serving tier reports per request (the paper's
    ReLU-count ≈ PI-latency claim, priced).

    ``mask_set``/``fingerprint`` stamp the identity of the set the request
    was *actually served under*; ``degraded_from`` records the set its SLO
    class originally routed to when overload admission degraded it to a
    cheaper budget — the bill then prices the degraded set, auditable
    against its fingerprint.
    """
    per_tok = cost(relu_count, n_nonlinear_layers, proto, linear_params)
    return {
        "relu_cost": int(relu_count),
        "tokens": int(tokens),
        "relus_billed": int(relu_count) * int(tokens),
        "pi_online_bytes": per_tok.online_bytes * tokens,
        "pi_offline_bytes": per_tok.offline_bytes * tokens,
        "pi_online_s": per_tok.online_latency_s * tokens,
        "mask_set": mask_set,
        "fingerprint": fingerprint,
        "degraded_from": degraded_from,
    }


def estimate_request_s(relu_count: int, n_nonlinear_layers: int,
                       prompt_tokens: int, gen_tokens: int,
                       proto: PIProtocol = PIProtocol()) -> float:
    """Model-side end-to-end latency estimate for one served request.

    The admission controller's price of a candidate admission before any
    measurement exists: every prompt position and every generated token is
    one forward at the mask set's per-token protocol cost.  The serve
    loop seeds its per-mask-set prefill/decode EWMAs from this estimate
    and refines them with measured latencies as requests complete.
    """
    per_tok = cost(relu_count, n_nonlinear_layers, proto)
    return per_tok.online_latency_s * (int(prompt_tokens) + int(gen_tokens))


def saving(b_ref: int, b_target: int, n_layers: int,
           proto: PIProtocol = PIProtocol()):
    """(latency_ref, latency_target, speedup) for a linearization run."""
    a = cost(b_ref, n_layers, proto)
    b = cost(b_target, n_layers, proto)
    return a.online_latency_s, b.online_latency_s, \
        a.online_latency_s / max(b.online_latency_s, 1e-12)
