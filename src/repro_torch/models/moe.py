"""Mixture-of-Experts FFN with sort-based (dropping) dispatch.

Counterpart of ``repro/models/moe.py``.  Routing is per row of the
explicit candidate axis: a (B, S, d) activation that the candidates still
share is routed once, B rows; a stacked (N, B, S, d) one is routed as N·B
rows.  Within a row: top-k of the router's softmax, a stable sort of the
(token, k) pairs by expert, a position within each expert, and a capacity
of C slots per expert (:func:`_capacity`): a pair whose position reaches C
is dropped.  The kept pairs are dispatched to an (E, C, d) slot tensor, the
experts run as batched products over the slots, and each token sums its k
expert outputs, weighted by its renormalised gates, in k order.

Two details make the port route as the reference does, bit for bit:

- ``lax.top_k`` breaks ties by the lower index; here a stable descending
  sort of the probabilities does, on the CPU and the card alike
  (``torch.topk`` promises no order among equal values);
- ``jnp.argsort`` is stable; here ``torch.sort(stable=True)`` is.  Which
  pairs overflow an expert depends on their order within it.

The combine is a gather per (token, k) and a sum over k in k order, never a
duplicate-index scatter-add, so stacked and one-at-a-time evaluation of
candidates sum in the same order.  The dispatch reads each token's row
once per (token, k) pair from a copy repeated k times
(:func:`_pair_rows`), so its backward sums a token's k gradients in a
fixed order: gathering the token's row k times would make the backward a
duplicate-index scatter-add, whose float atomics on the card sum in
another order from run to run, and the finetunes would not repeat bit for
bit.  The routed experts' gate is the mask
site ``moe``, of shape (E, F): the (…, E, C, F) gate input is laid out as
(…, C, E, F), rows of E·F columns, for ``linearize.apply_masked_act``
(kernels 1 and 2 on the card).  The shared expert is a gated FFN through
``layers.ffn`` (site ``moe_shared``), so it takes ``fused=`` like a dense
FFN.

``dispatch``: "scatter" writes each kept token's row into its slot,
"gather" reads each slot's source token (the reference's two modes, kept
for its GSPMD partitioning); both fill the same slots with the same rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import linearize
from . import layers


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # deepseek: always-on shared experts
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "scatter"    # 'scatter' | 'gather'


def moe_init(gen: torch.Generator, c: MoECfg, dtype=torch.bfloat16,
             device="cuda"):
    """Random parameters drawn from ``gen`` in the order router, w_gate,
    w_up, w_down, shared expert: the reference's tree (keys, shapes,
    dtypes; the router stays float32), not its numbers."""
    d, e, f = c.d_model, c.n_experts, c.d_ff_expert
    s = d ** -0.5
    p = {"router": layers.normal(gen, (d, e), s, torch.float32, device),
         "w_gate": layers.normal(gen, (e, d, f), s, dtype, device),
         "w_up": layers.normal(gen, (e, d, f), s, dtype, device),
         "w_down": layers.normal(gen, (e, f, d), f ** -0.5, dtype, device)}
    if c.n_shared:
        p["shared"] = layers.ffn_init(gen, d, c.d_ff_shared, gated=True,
                                      dtype=dtype, device=device)
    return p


def _capacity(c: MoECfg, seq: int) -> int:
    """Slots per expert: exactly 1 for a decode step (a token routes to at
    most one slot of each expert), else ``seq·k·capacity_factor / E`` + 1
    rounded up to a multiple of 8, at least 8."""
    cap = int(seq * c.top_k * c.capacity_factor / c.n_experts) + 1
    if seq == 1:
        return 1
    return max(8, -(-cap // 8) * 8)


def _top_k(logits, c: MoECfg):
    """(gates, experts), each (…, S, k): the k largest softmax
    probabilities, ties to the lower expert index, renormalised."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[..., :c.top_k], idx[..., :c.top_k]
    return gates / gates.sum(-1, keepdim=True), eidx


def _sorted_slots(eidx, c: MoECfg, C: int):
    """The (token, k) pairs of each row sorted stably by expert: the sort
    order, the source token of each sorted pair, whether it keeps a slot,
    and its slot (E·C for a dropped pair)."""
    *lead, S, k = eidx.shape
    flat_e = eidx.reshape(*lead, S * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = torch.div(order, k, rounding_mode="floor")    # token of each pair
    # position within the expert: index in the sorted order less the
    # index of the expert's first pair
    counts = torch.nn.functional.one_hot(se, c.n_experts).sum(-2)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(S * k, device=eidx.device) - \
        torch.gather(starts, -1, se)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, c.n_experts * C)
    return order, st, keep, slot


def _unsort(order, values):
    """``values`` given in sorted order, back in (token, k) order."""
    out = torch.empty_like(values)
    return out.scatter_(-1, order, values)


def _route(logits, c: MoECfg, C: int):
    """Routing bookkeeping of rows of logits (…, S, E): the gates
    (…, S, k), each slot's source token (…, E·C + 1), S for an empty slot
    and for the last (overflow) entry, and each (token, k) pair's slot
    (…, S, k), E·C where it was dropped."""
    *lead, S, _ = logits.shape
    gates, eidx = _top_k(logits, c)
    order, st, keep, slot = _sorted_slots(eidx, c, C)
    EC, n = c.n_experts * C, S * c.top_k
    # kept slots are unique; a dropped pair writes past the slot table, to
    # an entry of its own, so the scatter has no duplicate index
    spill = torch.where(keep, slot, EC + torch.arange(n, device=slot.device))
    slot_src = torch.full((*lead, EC + n), S, dtype=torch.int64,
                          device=slot.device)
    slot_src.scatter_(-1, spill, st)
    slot_src = torch.cat([slot_src[..., :EC],
                          slot_src.new_full((*lead, 1), S)], dim=-1)
    return gates, slot_src, _unsort(order, slot).reshape(*lead, S,
                                                         c.top_k)


def _pair_rows(x, k: int):
    """Rows x (…, S, d) repeated k times a token: (…, S·k, d) in (token,
    k) order.  Its backward sums each token's k gradients (a reduction in
    fixed order)."""
    return x.unsqueeze(-2).expand(*x.shape[:-1], k, x.shape[-1]) \
        .flatten(-3, -2)


def _dispatch_row(x, logits, c: MoECfg, C: int):
    """Rows x (…, S, d) and their logits (…, S, E) -> the slot tensor
    (…, E·C, d), kept tokens' rows in their slots and zeros elsewhere, and
    the bookkeeping ``(gates, slot_tk, keep_tk)`` in (token, k) order."""
    *lead, S, d = x.shape
    gates, eidx = _top_k(logits, c)
    order, _, keep, slot = _sorted_slots(eidx, c, C)
    EC = c.n_experts * C
    # sorted pair i reads copy order[i] (of token order[i] // k), once
    rows = torch.gather(_pair_rows(x, c.top_k), -2,
                        order[..., None].expand(*order.shape, d))
    rows = torch.where(keep[..., None], rows, 0)
    # duplicate indices occur only at the overflow slot, where every write
    # is zeros: the scatter's result does not depend on their order
    xg = x.new_zeros((*lead, EC + 1, d))
    xg.scatter_(-2, slot[..., None].expand(*slot.shape, d), rows)
    k = c.top_k
    book = (gates, _unsort(order, slot).reshape(*lead, S, k),
            _unsort(order, keep).reshape(*lead, S, k))
    return xg[..., :EC, :], book


def _slot_pairs(slot_tk, EC: int):
    """Each slot's (token, k) pair, from each pair's slot (…, S, k) (EC
    where it was dropped): (…, EC), S·k for an empty slot."""
    *lead, S, k = slot_tk.shape
    n = S * k
    flat = slot_tk.reshape(*lead, n)
    pairs = torch.arange(n, device=flat.device).expand(*lead, n)
    # a dropped pair writes past the slot table, to an entry of its own
    spill = torch.where(flat < EC, flat, EC + pairs)
    out = torch.full((*lead, EC + n), n, dtype=torch.int64,
                     device=flat.device)
    return out.scatter_(-1, spill, pairs)[..., :EC]


def _combine_row(y_slots, book, S: int, d: int):
    """Expert outputs (…, E·C, d) back to tokens (…, S, d): each token
    gathers its k slots' rows (the zero row where its pair was dropped) and
    sums them weighted by its gates, in k order.  ``y_slots`` may carry
    leading candidate axes that the bookkeeping (…, S, k) broadcasts
    over."""
    gates, slot_tk, keep_tk = book
    k = slot_tk.shape[-1]
    lead = y_slots.shape[:-2]
    ypad = torch.cat([y_slots, y_slots.new_zeros((*lead, 1, d))], dim=-2)
    idx = slot_tk.reshape(*slot_tk.shape[:-2], S * k, 1)
    idx = idx.expand(*lead, S * k, d)
    ytk = torch.gather(ypad, -2, idx).reshape(*lead, S, k, d)
    w = gates.to(ytk.dtype) * keep_tk.to(ytk.dtype)
    y = ytk[..., 0, :] * w[..., 0:1]
    for j in range(1, k):
        y = y + ytk[..., j, :] * w[..., j:j + 1]
    return y


def _experts(p, xe, mask, site, stacked_mask: bool, shared_x: bool, *,
             poly=None, soft=False, ties=True):
    """The routed experts on slot rows xe (G, E, C, d) -> (G, E, C, d),
    (N, G, E, C, d) for a shared xe under N stacked masks (``shared_x``),
    or (N, G / N, E, C, d) for stacked rows under stacked masks.

    Each product runs expert-major, one (rows, d) x (d, F) product an
    expert over every row's slots together (``torch.bmm`` over E), so an
    expert's weights are read once a product, not once a row.  The masked
    gate sees (…, C, E, F): rows of E·F columns."""
    G, E, C, d = xe.shape
    xs = xe.transpose(0, 1).reshape(E, G * C, d)
    F_ = p["w_gate"].shape[-1]
    h = torch.bmm(xs, p["w_gate"]).view(E, G, C, F_)
    up = torch.bmm(xs, p["w_up"]).view(E, G, C, F_).permute(1, 2, 0, 3)
    hT = h.permute(1, 2, 0, 3)                        # (G, C, E, F) view
    if stacked_mask:
        n = mask.shape[0]
        if shared_x:
            hT = hT.unsqueeze(0).expand((n,) + tuple(hT.shape))
        else:
            hT = hT.reshape((n, G // n) + tuple(hT.shape[1:]))
            up = up.reshape((n, G // n) + tuple(up.shape[1:]))
    a = linearize.apply_masked_act(hT, mask, site, poly=poly, soft=soft,
                                   ties=ties) * up    # (…, C, E, F)
    lead = a.shape[:-3]
    rows = a.reshape(-1, C, E, F_).permute(2, 0, 1, 3).reshape(E, -1, F_)
    y = torch.bmm(rows, p["w_down"]).view(E, -1, C, d)
    return y.transpose(0, 1).reshape(*lead, E, C, d)


def moe_ffn(p, c: MoECfg, x, mask, site: linearize.MaskSite,
            shared_mask=None, shared_site=None, *, poly=None,
            shared_poly=None, soft=False, fused=False, ties=True):
    """x: (B, S, d), or (N, B, S, d) stacked.  mask: (E, F) per-expert
    channel masks, or (N, E, F) for N stacked candidates; shared_mask:
    (F_s,) or (N, F_s) for the shared expert, whose gate takes
    ``shared_poly`` and ``fused`` (``layers.ffn``).  Returns (B, S, d), or
    (N, B, S, d) under stacked masks."""
    S, d = x.shape[-2:]
    C = _capacity(c, S)
    stacked_mask = mask.dim() == len(site.shape) + 1
    shared_x = stacked_mask and x.dim() == 3
    rows = x.reshape(-1, S, d)                        # one route per row
    logits = rows.to(torch.float32) @ p["router"]
    E = c.n_experts
    if c.dispatch == "gather":
        gates, _, slot_tk = _route(logits, c, C)
        # each slot reads its pair's copy of the token's row (_pair_rows)
        pairs = _pair_rows(rows, c.top_k)
        ppad = torch.cat([pairs, pairs.new_zeros((rows.shape[0], 1, d))], 1)
        src = _slot_pairs(slot_tk, E * C)[..., None].expand(-1, E * C, d)
        xe = torch.gather(ppad, 1, src)
        book = (gates, slot_tk, slot_tk < E * C)
    elif c.dispatch == "scatter":
        xe, book = _dispatch_row(rows, logits, c, C)
    else:
        raise ValueError(f"unknown MoE dispatch {c.dispatch!r}")
    ye = _experts(p, xe.reshape(-1, E, C, d), mask, site, stacked_mask,
                  shared_x, poly=poly, soft=soft, ties=ties)
    if stacked_mask and not shared_x:
        ye = ye.flatten(0, 1)             # the N·B rows that were routed
    y = _combine_row(ye.flatten(-3, -2), book, S, d)
    y = y.reshape(((mask.shape[0],) if shared_x else ()) + tuple(x.shape))
    if "shared" in p:
        y = y + layers.ffn(p["shared"], x, shared_mask, shared_site,
                           poly=shared_poly, soft=soft, fused=fused,
                           ties=ties)
    return y.to(x.dtype)
