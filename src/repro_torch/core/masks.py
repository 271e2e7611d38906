"""ReLU/activation mask pytrees.

A *mask tree* is a dict mapping a mask-site name (e.g. ``"layer3.relu2"`` for
CNNs or ``"blocks.ffn"`` for a scanned transformer stack) to a float32 array of
zeros/ones.  ``1.0`` keeps the nonlinearity at that coordinate, ``0.0``
linearizes it (identity or poly2 replacement — see core.linearize).

Masks are deliberately small (one scalar per activation *site*, shared across
the batch, matching the paper's per-pixel masks) so they are replicated across
the devices and updated host-side between evaluations.  All sampling /
counting helpers here are numpy-based host code: BCD mutates masks a few times
per outer iteration, never inside a device computation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MaskTree = Dict[str, np.ndarray]

# Mask coordinate values.  Binary masks use {0.0, 1.0}; `share` moves
# introduce a third *tied* state: the coordinate keeps its nonlinearity but
# reuses the sign decision of its leader (the previous coordinate along the
# site's last axis — see core.linearize.apply_masked_act), so it does not
# pay for its own garbled-circuit comparison.  TIE sits strictly inside
# (0.5, 0.9): `count` (> 0.5) still sees it as nonlinear, `relu_cost`
# (> 0.9) does not bill it.
TIE = 0.75


def as_device(masks: MaskTree, device="cuda"):
    """Move a host mask tree onto ``device`` as float32 torch tensors."""
    from repro_torch.convert import leaf_to_device
    return {k: leaf_to_device(v, device, np.float32)
            for k, v in masks.items()}


def full_masks(shapes: Dict[str, Tuple[int, ...]]) -> MaskTree:
    """All-ones masks (every nonlinearity kept) for the given site shapes."""
    return {k: np.ones(s, dtype=np.float32) for k, s in shapes.items()}


def count(masks: MaskTree) -> int:
    """||m||_0 — coordinates that keep *a* nonlinearity (full or tied)."""
    return int(sum(int(np.sum(v > 0.5)) for v in masks.values()))


def relu_cost(masks: MaskTree) -> int:
    """Billable ReLU count: coordinates that pay for their own comparison.

    This is the budget metric Alg. 2 descends (core.bcd) and the quantity
    the PI cost model charges for (core.pi_cost): share-tied coordinates
    (value :data:`TIE`) keep their gate but reuse the leader's comparison,
    so they are excluded.  Equal to :func:`count` on binary trees."""
    return int(sum(int(np.sum(v > 0.9)) for v in masks.values()))


def tied_count(masks: MaskTree) -> int:
    """Coordinates in the share-tied state (``0.5 < m <= 0.9``)."""
    return count(masks) - relu_cost(masks)


def total_size(masks: MaskTree) -> int:
    return int(sum(v.size for v in masks.values()))


def _flatten(masks: MaskTree) -> Tuple[np.ndarray, list]:
    """Concatenate all masks into one flat vector + per-site layout info."""
    keys = sorted(masks.keys())
    flat = np.concatenate([masks[k].reshape(-1) for k in keys])
    layout = []
    off = 0
    for k in keys:
        n = masks[k].size
        layout.append((k, off, n, masks[k].shape))
        off += n
    return flat, layout


def _unflatten(flat: np.ndarray, layout: list) -> MaskTree:
    out = {}
    for k, off, n, shape in layout:
        out[k] = flat[off:off + n].reshape(shape).astype(np.float32)
    return out


def active_indices(masks: MaskTree) -> Tuple[np.ndarray, list]:
    flat, layout = _flatten(masks)
    return np.nonzero(flat > 0.5)[0], layout


def sample_removal_block(
    rng: np.random.Generator, masks: MaskTree, drc: int
) -> MaskTree:
    """Sample a block of ``drc`` currently-active coordinates (Alg. 2 line 8).

    Returns a *candidate* mask tree: ``masks`` with the sampled block zeroed.
    If fewer than ``drc`` coordinates are active, zeroes all of them.
    """
    flat, layout = _flatten(masks)
    active = np.nonzero(flat > 0.5)[0]
    k = min(drc, active.size)
    chosen = rng.choice(active, size=k, replace=False)
    new_flat = flat.copy()
    new_flat[chosen] = 0.0
    return _unflatten(new_flat, layout)


# ------------------------------------------------------------ stacked trees
#
# A *stacked* mask tree carries ``n`` candidate trees along a leading axis:
# ``{site: (n, *site_shape)}``.  The batched/sharded evaluators (core.engine)
# consume stacked trees whole — one forward over the candidate axis
# evaluates all n candidates — so every helper here must index/slice
# consistently across sites.  Sampling is split into *index* sampling (tiny: (n, drc) ints) and
# *materialization* (per-chunk, so RT full-size candidate trees never live in
# host memory at once).


def sample_removal_indices(
    rng: np.random.Generator, masks: MaskTree, drc: int, n: int
) -> np.ndarray:
    """Sample ``n`` independent removal blocks as flat-coordinate indices.

    Row ``i`` is bit-identical to the ``rng.choice`` draw the ``i``-th
    sequential :func:`sample_removal_block` call would make from the same
    generator state — the engine relies on this for backend equivalence.
    Returns an (n, k) int array, k = min(drc, #active).
    """
    active, _ = active_indices(masks)
    k = min(drc, active.size)
    return np.stack([rng.choice(active, size=k, replace=False)
                     for _ in range(n)]) if n else \
        np.zeros((0, k), dtype=np.int64)


def materialize_from_flat(flat: np.ndarray, layout: list,
                          indices: np.ndarray) -> MaskTree:
    """Stacked candidate tree from a pre-flattened base mask.

    The hot path: BCD flattens the base tree once per outer step and
    materializes each chunk from (flat, layout) without re-concatenating
    the whole tree per chunk."""
    n = indices.shape[0]
    stacked = np.broadcast_to(flat, (n, flat.size)).copy()
    np.put_along_axis(stacked, indices, 0.0, axis=1)
    return unflatten_stacked(stacked, layout)


def materialize_candidates(masks: MaskTree, indices: np.ndarray) -> MaskTree:
    """Build the stacked candidate tree for (n, k) removal ``indices``."""
    flat, layout = _flatten(masks)
    return materialize_from_flat(flat, layout, indices)


def chunk_bounds(n: int, chunk_size: int) -> list:
    """[(start, stop)] chunk boundaries covering ``n`` candidates."""
    return [(s, min(s + chunk_size, n)) for s in range(0, n, chunk_size)]


def coalesce_fallback_chunks(chunks: list, chunk_size: int) -> list:
    """Merge runs of adjacent fallback chunks in a sited plan.

    ``chunks``: ``[(site | None, start, stop)]`` with contiguous ascending
    bounds (``plan_sited_chunks`` raw output).  Sited chunks pass through
    untouched — they must never straddle a prefix group.  Consecutive
    ``site is None`` chunks carry no shared-prefix constraint (the inner
    pipeline runs each candidate's full forward), so their spans are merged
    and re-split at ``chunk_size``: a depth mix that fragments into many
    small per-group fallback tails then costs ceil(total/chunk) dispatches
    instead of one ragged dispatch per group."""
    out: list = []
    run_start = run_stop = None
    for site, s, e in chunks:
        if site is None:
            if run_stop == s:
                run_stop = e
            else:
                if run_start is not None:
                    out.extend((None, run_start + cs, run_start + ce)
                               for cs, ce in chunk_bounds(
                                   run_stop - run_start, chunk_size))
                run_start, run_stop = s, e
            continue
        if run_start is not None:
            out.extend((None, run_start + cs, run_start + ce)
                       for cs, ce in chunk_bounds(run_stop - run_start,
                                                  chunk_size))
            run_start = run_stop = None
        out.append((site, s, e))
    if run_start is not None:
        out.extend((None, run_start + cs, run_start + ce)
                   for cs, ce in chunk_bounds(run_stop - run_start,
                                              chunk_size))
    return out


def materialize_chunks(flat: np.ndarray, layout: list, indices: np.ndarray,
                       chunk_size: int):
    """Lazy chunk producer for the trial loop: yields one stacked candidate
    tree per :func:`chunk_bounds` chunk of ``indices``.

    Laziness is load-bearing twice over — the prefetch pipeline
    (core.engine.evaluate_prefetched) pulls chunk k+1's materialization
    while chunk k computes on device, and an ADT early exit closes the
    generator so chunks past the staging horizon are never built."""
    for start, stop in chunk_bounds(indices.shape[0], chunk_size):
        yield materialize_from_flat(flat, layout, indices[start:stop])


def _repeat_row_sizes(layout: list,
                      repeat_sites: Optional[Dict[str, int]]) -> np.ndarray:
    """Per-layout-entry repeat-row size for repeat-aware rank resolution.

    A site in ``repeat_sites`` spans R consecutive per-repeat ranks from its
    base rank, with its flat coordinates laid out repeat-major — so a
    coordinate's rank offset is ``local_offset // (size // R)``.  Sites not
    listed have one repeat: row size = site size, offset always 0."""
    return np.array([sz // int((repeat_sites or {}).get(k, 1))
                     for k, _, sz, _ in layout], dtype=np.int64)


def group_blocks_by_site(indices: np.ndarray, layout: list,
                         rank_of_site: Dict[str, int],
                         repeat_sites: Optional[Dict[str, int]] = None):
    """Group candidate removal blocks by their *earliest* touched site rank.

    ``indices``: (n, k) flat removal coordinates (``sample_removal_indices``
    output); ``layout``: the matching ``_flatten`` layout; ``rank_of_site``:
    site name -> group rank — pass the model's segment indices so candidates
    that share a forward prefix land in the same group (the prefix-reuse
    engine's chunking contract: chunks never straddle a group).

    ``repeat_sites`` (site -> R) marks scanned-stack sites whose (R, ·)
    mask spans R consecutive per-repeat segments starting at the site's
    base rank: a coordinate's effective rank is then
    ``rank_of_site[site] + local_offset // (size // R)``, so candidates
    editing only deep repeats group at their true (deeper) cut instead of
    the whole-stack one.

    Returns ``(order, groups)``: ``order`` is an (n,) permutation of
    candidate positions sorted by group rank (stable, so sampling order
    survives within a group), and ``groups`` is ``[(rank, start, stop)]``
    bounds into ``order``.
    """
    n = indices.shape[0]
    if n == 0 or indices.size == 0:
        return np.arange(n, dtype=np.int64), \
            ([] if n == 0 else [(0, 0, n)])
    offs = np.array([off for _, off, _, _ in layout], dtype=np.int64)
    ranks = np.array([rank_of_site[k] for k, _, _, _ in layout],
                     dtype=np.int64)
    flat = indices.reshape(-1)
    site_of = np.searchsorted(offs, flat, side="right") - 1
    coord_rank = ranks[site_of]
    if repeat_sites:
        row_sz = _repeat_row_sizes(layout, repeat_sites)
        coord_rank = coord_rank + (flat - offs[site_of]) // row_sz[site_of]
    cand_rank = coord_rank.reshape(indices.shape).min(axis=1)
    return _group_by_rank(cand_rank)


def _group_by_rank(cand_rank: np.ndarray):
    """Stable-sort candidate positions by rank -> (order, groups) in the
    :func:`group_blocks_by_site` contract (shared with the move-aware
    grouping :func:`group_moves_by_site`)."""
    n = cand_rank.shape[0]
    order = np.argsort(cand_rank, kind="stable").astype(np.int64)
    sorted_ranks = cand_rank[order]
    cuts = np.flatnonzero(np.diff(sorted_ranks)) + 1
    bounds = [0, *cuts.tolist(), n]
    groups = [(int(sorted_ranks[s]), s, e)
              for s, e in zip(bounds[:-1], bounds[1:])]
    return order, groups


# ------------------------------------------------------------ typed moves
#
# The paper's Alg. 2 samples one move type only — "zero a block of drc
# active coordinates".  The move vocabulary below generalizes a candidate to
# a typed edit of the flat mask vector while keeping the engine's contracts
# intact: every sampled move changes the *billable* budget (`relu_cost`) by
# exactly -drc, so the outer schedule (core.bcd.total_steps /
# check_reached_target) is untouched, and all sampling happens up front so
# the rng burns a deterministic number of draws per candidate regardless of
# evaluation order or early exit.

MOVE_KINDS = ("remove", "add_back", "swap", "stage_drop", "share")
PROPOSALS = ("uniform", "sensitivity")


def _as_coords(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1)


@dataclasses.dataclass(frozen=True)
class Move:
    """One typed candidate edit over flat mask coordinates.

    ``off`` coordinates are set to 0.0 (linearized), ``on`` to 1.0
    (re-activated), ``tie`` to :data:`TIE` (share-tied to the previous
    coordinate on the site's last axis).  The three sets must be disjoint;
    application order is irrelevant.  ``kind`` is a label for stats /
    logging — semantics live entirely in the coordinate sets, which is what
    makes the move algebra checkable: ``swap(off, on)`` applies identically
    to ``add_back(on) ∘ remove(off)``.
    """
    kind: str
    off: np.ndarray = dataclasses.field(default_factory=lambda: _as_coords([]))
    on: np.ndarray = dataclasses.field(default_factory=lambda: _as_coords([]))
    tie: np.ndarray = dataclasses.field(default_factory=lambda: _as_coords([]))

    def __post_init__(self):
        object.__setattr__(self, "off", _as_coords(self.off))
        object.__setattr__(self, "on", _as_coords(self.on))
        object.__setattr__(self, "tie", _as_coords(self.tie))
        sets = [set(self.off.tolist()), set(self.on.tolist()),
                set(self.tie.tolist())]
        total = len(sets[0]) + len(sets[1]) + len(sets[2])
        if len(sets[0] | sets[1] | sets[2]) != total:
            raise ValueError(
                f"move coordinate sets must be disjoint (kind={self.kind}, "
                f"off={self.off}, on={self.on}, tie={self.tie})")

    # ---- constructors (the algebra the property tests exercise)

    @staticmethod
    def remove(off) -> "Move":
        return Move("remove", off=off)

    @staticmethod
    def add_back(on, off=()) -> "Move":
        return Move("add_back", off=off, on=on)

    @staticmethod
    def swap(off, on) -> "Move":
        return Move("swap", off=off, on=on)

    @staticmethod
    def stage_drop(off) -> "Move":
        return Move("stage_drop", off=off)

    @staticmethod
    def share(tie, off=()) -> "Move":
        return Move("share", off=off, tie=tie)

    def touched(self) -> np.ndarray:
        """All flat coordinates this move edits (off ∪ on ∪ tie)."""
        return np.concatenate([self.off, self.on, self.tie])

    def apply_flat(self, flat: np.ndarray) -> np.ndarray:
        out = flat.copy()
        out[self.off] = 0.0
        out[self.on] = 1.0
        out[self.tie] = TIE
        return out

    def billable_delta(self, flat: np.ndarray) -> int:
        """Change in :func:`relu_cost` if applied to ``flat``."""
        before = int(np.sum(flat > 0.9))
        return int(np.sum(self.apply_flat(flat) > 0.9)) - before


def apply_move(masks: MaskTree, move: Move) -> MaskTree:
    """``masks`` with ``move`` applied (input untouched)."""
    flat, layout = _flatten(masks)
    return _unflatten(move.apply_flat(flat), layout)


def move_sites(move: Move, layout: list) -> Tuple[str, ...]:
    """Sorted site names a move touches (for per-site acceptance stats)."""
    coords = move.touched()
    if coords.size == 0:
        return ()
    offs = np.array([off for _, off, _, _ in layout], dtype=np.int64)
    keys = [k for k, _, _, _ in layout]
    site_of = np.searchsorted(offs, coords, side="right") - 1
    return tuple(sorted({keys[int(i)] for i in site_of}))


_STAGE_RE = re.compile(r"^(g\d+)b\d+")


def default_stage_of(site: str) -> str:
    """Model-agnostic site -> stage key for ``stage_drop`` macro-moves.

    ResNet block sites (``g{stage}b{block}.relu{i}``, models.resnet) map to
    their stage (``g0b1.relu2 -> g0``); everything else maps to its
    top-level prefix (``stem.relu -> stem``, ``blocks.ffn -> blocks``).
    Pass an explicit ``stage_of`` to :func:`sample_moves` to override."""
    m = _STAGE_RE.match(site)
    return m.group(1) if m else site.split(".", 1)[0]


def _kind_weights(kinds: Sequence[str], proposal: str,
                  move_stats: Optional[dict]) -> np.ndarray:
    """Proposal distribution over move kinds.

    ``uniform``: equal mass.  ``sensitivity``: Laplace-smoothed acceptance
    rate per kind from the run's history (Learning-to-Linearize-style
    guidance) — a pure function of ``move_stats``, which round-trips
    through checkpoints, so resumed runs replay the same draws."""
    if proposal != "sensitivity" or not move_stats:
        return np.full(len(kinds), 1.0 / len(kinds))
    ks = move_stats.get("kinds", {})
    w = np.array([(ks.get(k, {}).get("accepted", 0) + 1.0)
                  / (ks.get(k, {}).get("proposed", 0) + 2.0) for k in kinds],
                 dtype=np.float64)
    return w / w.sum()


def _site_coord_weights(flat: np.ndarray, layout: list, coords: np.ndarray,
                        move_stats: Optional[dict]) -> Optional[np.ndarray]:
    """Per-coordinate sampling weights from per-site acceptance history
    (``sensitivity`` proposal): a coordinate inherits its site's smoothed
    acceptance rate.  None -> uniform (no history yet)."""
    site_stats = (move_stats or {}).get("sites", {})
    if not site_stats or coords.size == 0:
        return None
    offs = np.array([off for _, off, _, _ in layout], dtype=np.int64)
    keys = [k for k, _, _, _ in layout]
    w_site = np.array(
        [(site_stats.get(k, {}).get("accepted", 0) + 1.0)
         / (site_stats.get(k, {}).get("proposed", 0) + 2.0) for k in keys],
        dtype=np.float64)
    p = w_site[np.searchsorted(offs, coords, side="right") - 1]
    return p / p.sum()


def _choice(rng, pool: np.ndarray, k: int, p=None) -> np.ndarray:
    if k <= 0:
        return _as_coords([])
    return _as_coords(rng.choice(pool, size=k, replace=False, p=p)) \
        if p is not None else \
        _as_coords(rng.choice(pool, size=k, replace=False))


def _sample_one_move(rng, flat, layout, drc, kind, proposal, move_stats,
                     stage_of, max_remove) -> Move:
    """Sample one candidate of the given kind (net billable change -drc).

    Kinds that cannot be realized in the current mask state (no inactive
    coordinate to add back, no share-eligible coordinate, ...) degrade to a
    plain removal so the candidate still advances the schedule.  ``remove``
    with the default uniform proposal burns exactly the legacy
    ``rng.choice(active, size=k, replace=False)`` draw — bit-identical to
    :func:`sample_removal_indices` — so ``moves=("remove",)`` configs
    replay historical runs unchanged."""
    active = np.nonzero(flat > 0.9)[0]
    k = min(drc, active.size)

    if kind == "remove":
        p = _site_coord_weights(flat, layout, active, move_stats) \
            if proposal == "sensitivity" else None
        return Move.remove(_choice(rng, active, k, p))

    if kind == "add_back":
        inactive = np.nonzero(flat <= 0.5)[0]
        # re-activate `a`, remove k + a: net -k.  Shrink a when there is
        # nothing to revive or too few actives to pay for the revival.
        a = min(1, inactive.size, max(0, active.size - k))
        if a == 0:
            return Move.remove(_choice(rng, active, k))
        on = _choice(rng, inactive, a)
        return Move.add_back(on, off=_choice(rng, active, k + a))

    if kind == "swap":
        # exchange one (off, on) pair inside a single site, plus k rider
        # removals that keep the step's budget schedule
        offs_l = {key: (off, n) for key, off, n, _ in layout}
        eligible = [key for key, off, n, _ in layout
                    if np.any(flat[off:off + n] > 0.9)
                    and np.any(flat[off:off + n] <= 0.5)]
        if not eligible or active.size <= k:
            return Move.remove(_choice(rng, active, k))
        site = eligible[int(rng.integers(len(eligible)))]
        off0, n0 = offs_l[site]
        local = flat[off0:off0 + n0]
        on = _choice(rng, np.nonzero(local <= 0.5)[0] + off0, 1)
        off_sw = _choice(rng, np.nonzero(local > 0.9)[0] + off0, 1)
        rest = np.setdiff1d(active, off_sw, assume_unique=True)
        return Move.swap(np.concatenate([off_sw, _choice(rng, rest, k)]), on)

    if kind == "stage_drop":
        # DeepReDuce-style macro-move: remove a whole stage's remaining
        # actives (never overshooting b_target, never under drc)
        stage_of = stage_of or default_stage_of
        cap = k if max_remove is None else max(k, min(int(max_remove),
                                                      active.size))
        stages: Dict[str, list] = {}
        for key, off, n, _ in layout:
            hot = np.nonzero(flat[off:off + n] > 0.9)[0] + off
            if hot.size:
                stages.setdefault(stage_of(key), []).append(hot)
        names = sorted(stages)
        if not names:
            return Move.remove(_choice(rng, active, k))
        st = names[int(rng.integers(len(names)))]
        pool = np.concatenate(stages[st])
        take = min(pool.size, cap)
        off = pool if take == pool.size else _choice(rng, pool, take)
        if take < k:            # tiny stage: top up to the schedule's drc
            rest = np.setdiff1d(active, off, assume_unique=True)
            off = np.concatenate([off, _choice(rng, rest, k - take)])
        return Move.stage_drop(off)

    if kind == "share":
        eligible = share_eligible(flat, layout)
        perm = _as_coords(rng.permutation(eligible)) if eligible.size \
            else eligible
        chosen: list = []
        taken = set()
        for idx in perm.tolist():
            if len(chosen) >= k:
                break
            if idx - 1 in taken or idx + 1 in taken:
                continue        # the leader must stay a full ReLU
            chosen.append(idx)
            taken.add(idx)
        tie = _as_coords(chosen)
        if tie.size < k:        # not enough tie sites: top up with removals
            leaders = tie - 1
            pool = np.setdiff1d(active, np.concatenate([tie, leaders]),
                                assume_unique=False)
            if k - tie.size > pool.size:
                # cannot reach -drc with ties + removals (end-of-schedule
                # corner): a plain removal always can
                return Move.remove(_choice(rng, active, k))
            return Move.share(tie, off=_choice(rng, pool, k - tie.size))
        return Move.share(tie)

    raise ValueError(f"unknown move kind {kind!r}; expected one of "
                     f"{MOVE_KINDS}")


def share_eligible(flat: np.ndarray, layout: list) -> np.ndarray:
    """Flat coordinates a ``share`` move may tie: billable actives whose
    leader — the previous coordinate along the site's last axis — exists
    (no wraparound) and is itself a billable active."""
    out = []
    for _, off, n, shape in layout:
        local = flat[off:off + n] > 0.9
        last = shape[-1] if shape else 1
        pos = np.arange(n) % last
        ok = local & (pos > 0)
        ok[1:] &= local[:-1]
        ok[:1] = False
        out.append(np.nonzero(ok)[0] + off)
    return np.concatenate(out) if out else _as_coords([])


def sample_moves(
    rng: np.random.Generator, masks: MaskTree, drc: int, n: int, *,
    kinds: Sequence[str] = ("remove",), proposal: str = "uniform",
    move_stats: Optional[dict] = None, stage_of=None,
    max_remove: Optional[int] = None,
) -> List[Move]:
    """Sample ``n`` independent typed candidates (Alg. 2 line 8, typed).

    Every candidate nets exactly ``-drc`` billable ReLUs (``stage_drop``
    may remove more, capped by ``max_remove`` — pass ``budget - b_target``
    so macro-moves never overshoot the schedule).  With the default
    ``kinds=("remove",)`` and ``proposal="uniform"`` the rng stream is
    bit-identical to :func:`sample_removal_indices`: no kind draw is made
    and each candidate burns one ``rng.choice`` over the active set.
    """
    for kind in kinds:
        if kind not in MOVE_KINDS:
            raise ValueError(f"unknown move kind {kind!r}; expected a "
                             f"subset of {MOVE_KINDS}")
    if proposal not in PROPOSALS:
        raise ValueError(f"unknown proposal {proposal!r}; expected one of "
                         f"{PROPOSALS}")
    flat, layout = _flatten(masks)
    weights = _kind_weights(kinds, proposal, move_stats) \
        if len(kinds) > 1 else None
    moves = []
    for _ in range(n):
        kind = kinds[0] if weights is None else \
            kinds[int(rng.choice(len(kinds), p=weights))]
        moves.append(_sample_one_move(rng, flat, layout, drc, kind,
                                      proposal, move_stats, stage_of,
                                      max_remove))
    return moves


def materialize_moves_from_flat(flat: np.ndarray, layout: list,
                                moves: Sequence[Move]) -> MaskTree:
    """Stacked candidate tree for typed moves (the move-aware counterpart
    of :func:`materialize_from_flat` — candidate ``i`` is
    ``moves[i].apply_flat(flat)``)."""
    n = len(moves)
    stacked = np.broadcast_to(flat, (n, flat.size)).copy()
    for i, mv in enumerate(moves):
        stacked[i, mv.off] = 0.0
        stacked[i, mv.on] = 1.0
        stacked[i, mv.tie] = TIE
    return unflatten_stacked(stacked, layout)


def materialize_move_chunks(flat: np.ndarray, layout: list,
                            moves: Sequence[Move], chunk_size: int):
    """Lazy chunk producer over typed moves (same laziness contract as
    :func:`materialize_chunks`: the prefetch pipeline pulls it, an ADT
    early exit closes it)."""
    for start, stop in chunk_bounds(len(moves), chunk_size):
        yield materialize_moves_from_flat(flat, layout, moves[start:stop])


def move_site_ranks(moves: Sequence[Move], layout: list,
                    rank_of_site: Dict[str, int],
                    repeat_sites: Optional[Dict[str, int]] = None
                    ) -> np.ndarray:
    """Each move's earliest-touched-site rank over off ∪ on ∪ tie.

    Multi-site moves (swap/share/add_back) are grouped by the *shallowest*
    site they edit: a cached forward prefix is only valid if it reads no
    edited mask, so the cut must sit at or above every touched coordinate.
    ``repeat_sites`` resolves scanned-stack coordinates to their per-repeat
    rank (same contract as :func:`group_blocks_by_site`)."""
    offs = np.array([off for _, off, _, _ in layout], dtype=np.int64)
    ranks = np.array([rank_of_site[k] for k, _, _, _ in layout],
                     dtype=np.int64)
    row_sz = _repeat_row_sizes(layout, repeat_sites) if repeat_sites else None
    out = np.empty(len(moves), dtype=np.int64)
    for i, mv in enumerate(moves):
        coords = mv.touched()
        if not coords.size:
            out[i] = int(ranks.min())
            continue
        site_of = np.searchsorted(offs, coords, side="right") - 1
        r = ranks[site_of]
        if row_sz is not None:
            r = r + (coords - offs[site_of]) // row_sz[site_of]
        out[i] = int(r.min())
    return out


def group_moves_by_site(moves: Sequence[Move], layout: list,
                        rank_of_site: Dict[str, int],
                        repeat_sites: Optional[Dict[str, int]] = None):
    """:func:`group_blocks_by_site` for typed moves: group by the earliest
    touched site over off ∪ on ∪ tie (same ``(order, groups)`` and
    ``repeat_sites`` contract)."""
    n = len(moves)
    if n == 0:
        return np.arange(0, dtype=np.int64), []
    return _group_by_rank(
        move_site_ranks(moves, layout, rank_of_site, repeat_sites))


def sample_removal_indices_within(
    rng: np.random.Generator, masks: MaskTree, drc: int, n: int,
    sites: Iterable[str], repeat_sites: Optional[Dict[str, int]] = None
) -> np.ndarray:
    """:func:`sample_removal_indices` restricted to the given sites'
    coordinates — site-local candidate blocks for the per-site-depth
    benchmark.  NOT part of Alg. 2's rng discipline (the real sampler draws
    from the global active set); returns (n, min(drc, #active-in-sites)).

    Site names may be repeat-qualified (``"s0.ffn@1"`` — models.lm virtual
    stack sites) when ``repeat_sites`` maps the base mask name to its
    repeat count R: coordinates are then restricted to repeat r's row of
    the stacked (R, ·) mask, so the benchmark can build candidates that
    cut at one specific scan repeat.
    """
    flat, layout = _flatten(masks)
    wanted: Dict[str, set] = {}
    for s in sites:
        base, _, rtag = str(s).partition("@")
        wanted.setdefault(base, set()).add(int(rtag) if rtag else None)
    sel = np.zeros(flat.size, dtype=bool)
    for k, off, sz, _ in layout:
        rows = wanted.get(k)
        if rows is None:
            continue
        row = sz // int((repeat_sites or {}).get(k, 1))
        for r in rows:
            if r is None:
                sel[off:off + sz] = True
            else:
                sel[off + r * row:off + (r + 1) * row] = True
    if not sel.any():
        raise ValueError(f"no mask coordinates in sites {sorted(set(sites))}")
    active = np.nonzero((flat > 0.5) & sel)[0]
    k = min(drc, active.size)
    return np.stack([rng.choice(active, size=k, replace=False)
                     for _ in range(n)]) if n else \
        np.zeros((0, k), dtype=np.int64)


def sample_removal_blocks(
    rng: np.random.Generator, masks: MaskTree, drc: int, n: int
) -> MaskTree:
    """Vectorized :func:`sample_removal_block`: ``n`` candidates, stacked.

    Candidate ``i`` equals the tree ``i`` sequential calls would produce
    (same rng draw order), so backends that pre-sample match backends that
    sample lazily."""
    return materialize_candidates(
        masks, sample_removal_indices(rng, masks, drc, n))


def unflatten_stacked(stacked_flat: np.ndarray, layout: list) -> MaskTree:
    """(n, total) flat candidates -> stacked tree {site: (n, *shape)}."""
    n = stacked_flat.shape[0]
    out = {}
    for k, off, sz, shape in layout:
        out[k] = stacked_flat[:, off:off + sz].reshape((n,) + tuple(shape)) \
            .astype(np.float32)
    return out


def flatten_stacked(stacked: MaskTree) -> Tuple[np.ndarray, list]:
    """Inverse of :func:`unflatten_stacked` (layout shapes are per-site)."""
    keys = sorted(stacked.keys())
    n = next(iter(stacked.values())).shape[0]
    flat = np.concatenate([stacked[k].reshape(n, -1) for k in keys], axis=1)
    layout, off = [], 0
    for k in keys:
        sz = int(np.prod(stacked[k].shape[1:], dtype=np.int64))
        layout.append((k, off, sz, stacked[k].shape[1:]))
        off += sz
    return flat, layout


def stack_trees(trees: Iterable[MaskTree]) -> MaskTree:
    """Stack individual mask trees along a new leading candidate axis."""
    trees = list(trees)
    return {k: np.stack([t[k] for t in trees]) for k in trees[0]}


def stacked_len(stacked: MaskTree) -> int:
    return int(next(iter(stacked.values())).shape[0])


def index_stacked(stacked: MaskTree, i: int) -> MaskTree:
    """Candidate ``i`` of a stacked tree, as an ordinary mask tree."""
    return {k: np.asarray(v[i], dtype=np.float32)
            for k, v in stacked.items()}


def slice_stacked(stacked: MaskTree, start: int, stop: int) -> MaskTree:
    return {k: v[start:stop] for k, v in stacked.items()}


def pad_stacked(stacked: MaskTree, n: int) -> MaskTree:
    """Pad the candidate axis to ``n`` by repeating the last candidate
    (every chunk then has one shape, ragged final chunks included)."""
    have = stacked_len(stacked)
    if have >= n:
        return stacked
    return {k: np.concatenate(
        [v, np.broadcast_to(v[-1:], (n - have,) + v.shape[1:])])
        for k, v in stacked.items()}


def stacked_counts(stacked: MaskTree) -> np.ndarray:
    """Per-candidate ||m||_0 over a stacked tree — vectorized ``count``."""
    n = stacked_len(stacked)
    return sum(np.sum(v.reshape(n, -1) > 0.5, axis=1) for v in
               stacked.values()).astype(np.int64)


def stacked_relu_costs(stacked: MaskTree) -> np.ndarray:
    """Per-candidate billable ReLUs — vectorized :func:`relu_cost`."""
    n = stacked_len(stacked)
    return sum(np.sum(v.reshape(n, -1) > 0.9, axis=1) for v in
               stacked.values()).astype(np.int64)


def remove_random(rng: np.random.Generator, masks: MaskTree, n: int) -> MaskTree:
    """Uniform random removal (the naive baseline BCD is compared against)."""
    return sample_removal_block(rng, masks, n)


def intersection_over_union(m1: MaskTree, m2: MaskTree) -> float:
    """Paper Fig. 6 IoU: ||m1 ⊙ m2||_0 / ||m1||_0 (m1 = smaller budget)."""
    inter = sum(float(np.sum((a > 0.5) & (m2[k] > 0.5))) for k, a in m1.items())
    denom = float(count(m1))
    return inter / max(denom, 1.0)


def is_subset(m_small: MaskTree, m_big: MaskTree) -> bool:
    """True iff every active coordinate of m_small is active in m_big."""
    for k, a in m_small.items():
        if np.any((a > 0.5) & ~(m_big[k] > 0.5)):
            return False
    return True


def fingerprint(masks: MaskTree) -> str:
    """Content hash of a binary mask tree: sha256 over sorted site names,
    shapes, and packed mask bits.  Two trees fingerprint equal iff they
    keep/linearize exactly the same coordinates — the identity used by
    resume tests and the sweep curve artifact (float payloads are reduced
    to their >0.5 binarization, so dtype/storage differences don't leak
    into the identity).  Sites carrying share-tied coordinates additionally
    hash their >0.9 (leader) plane, so a tied tree and its fully-active
    binarization fingerprint differently; binary sites hash exactly as they
    always have."""
    h = hashlib.sha256()
    for k in sorted(masks.keys()):
        v = np.asarray(masks[k])
        h.update(k.encode())
        h.update(repr(tuple(v.shape)).encode())
        nz = v.reshape(-1) > 0.5
        h.update(np.packbits(nz).tobytes())
        full = v.reshape(-1) > 0.9
        if bool(np.any(nz & ~full)):
            h.update(b"tied")
            h.update(np.packbits(full).tobytes())
    return h.hexdigest()


def per_site_counts(masks: MaskTree) -> Dict[str, int]:
    """Paper Fig. 7 — ReLU distribution across layers/sites."""
    return {k: int(np.sum(v > 0.5)) for k, v in sorted(masks.items())}


def threshold(soft_masks: MaskTree, budget: int) -> MaskTree:
    """Hard-threshold soft (real-valued) masks to exactly ``budget`` ones.

    Keeps the ``budget`` largest coordinates globally — this is SNL's final
    binarization step (the step the paper identifies as the accuracy cliff).
    """
    flat, layout = _flatten(soft_masks)
    budget = min(budget, flat.size)
    out = np.zeros_like(flat)
    if budget > 0:
        keep = np.argpartition(flat, -budget)[-budget:]
        out[keep] = 1.0
    return _unflatten(out, layout)
