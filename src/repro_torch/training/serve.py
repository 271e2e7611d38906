"""Serving: batched prefill + single-token decode over a resident cache.

Counterpart of ``repro/training/serve.py``.  The reference jits closures
over ``LM.forward`` with the cache as a jit input and output; here the
closures are plain functions and the cache is written in place
(``models.lm.LM.forward(cache=)``).

Over a ``("data", "model")`` mesh (``ServeCfg``, ``serve_shardings``,
``_cache_specs``, ``jit_prefill``, ``jit_decode_step``, under the
reference's names; there is no jit): every rank runs the same function on
its shards, the batch split over ``"data"`` where it divides and the model
tensor-parallel over ``"model"`` (``models.lm.LM`` on a mesh).  The
reference's placements are returned beside the layout the port holds.

Also here: :class:`MaskSetStore`, several ReLU budgets served from one
resident parameter set, and the slot surgery of continuous batching
(:func:`make_insert_slot`, :func:`read_slot_tokens`).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import masks as M, pi_cost


def make_prefill(model):
    """Prefill function: ``(params, masks, tokens, cache) -> (last logits
    (B, V), cache)``, the cache filled in place from position 0.
    :func:`jit_prefill` on no mesh."""
    return jit_prefill(model, None, ServeCfg())


def make_decode_step(model):
    """Greedy single-token decode over a running cache:
    ``(params, masks, token (B, 1), cache, cache_len) -> (next token
    (B, 1) int32, cache, last-position logits (B, V))``; ``cache_len`` an
    int or a (B,) array of per-slot positions.  The reference returns the
    first two; the logits are the ones the token was taken from.
    :func:`jit_decode_step` on no mesh."""
    return jit_decode_step(model, None, ServeCfg())


# ------------------------------------------------------------ over a mesh


@dataclasses.dataclass
class ServeCfg:
    """Serving shape/placement knobs (batch, cache length, DP axes)."""

    dp_axes: Tuple[str, ...] = ("data",)
    max_len: int = 32768
    batch: int = 128
    greedy: bool = True


class ServeShardings(NamedTuple):
    """The reference's placements (``params``, ``cache``) and the layouts
    the port holds (``held_params``, ``held_cache``); trees of
    ``spmd.Spec``."""

    params: object
    cache: object
    held_params: object
    held_cache: object


def _sizes(mesh) -> Dict[str, int]:
    """Mesh axis sizes: a ``DeviceMesh``, or a mapping name -> size (the
    reference's ``mesh.shape``)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    from repro_torch.launch import mesh as mesh_lib
    return {n: mesh_lib.axis(mesh, n).size for n in mesh.mesh_dim_names}


def _dp(mesh, dp_axes) -> int:
    n = 1
    sizes = _sizes(mesh)
    for a in dp_axes:
        n *= sizes[a]
    return n


def serve_shardings(model, mesh, cfg: ServeCfg) -> ServeShardings:
    """The reference's ``(param placements, cache placements)`` — the
    parameters by ``param_specs(fsdp=False)``, the caches by
    :func:`_cache_specs` — and the layouts the port holds
    (``models.lm.held_param_specs``, ``models.lm.held_cache_specs``).
    ``mesh``: a ``DeviceMesh`` or ``{"data": d, "model": m}``."""
    from repro_torch.models import lm as lm_lib
    sizes = _sizes(mesh)
    data, model_ax = sizes.get("data", 1), sizes.get("model", 1)
    dp_size = _dp(mesh, cfg.dp_axes)
    pspec = lm_lib.param_specs(model.param_shapes(), data, model_ax,
                               fsdp=False)
    cshapes = lm_lib.LM(model.cfg).init_cache(cfg.batch, cfg.max_len,
                                              "meta")
    cspec = _cache_specs(cshapes, cfg.dp_axes, dp_size, cfg.batch, data,
                         model_ax)
    return ServeShardings(
        pspec, cspec, lm_lib.held_param_specs(pspec, model.cfg, model_ax),
        lm_lib.held_cache_specs(cshapes, cfg.dp_axes, dp_size, cfg.batch,
                                data, model_ax))


def _cache_specs(cache_shape, dp_axes, dp_size: int, B: int, data: int,
                 model_ax: int):
    """The reference's rule, as it is.  KV (B,S,KV,hd) with S >= 1024:
    batch over dp if divisible, else seq over 'data'; heads (or head_dim)
    over 'model' when divisible.  Any other 4-D leaf (SSM/RWKV states, and
    a KV cache shorter than 1024, whose sequence axis the rule then puts
    on 'model'): batch over dp, its second axis over 'model'.  Conv state
    (B, dc-1, di): di over 'model'; prev-token (B, d): d over 'model'."""
    from repro_torch.core import spmd
    from repro_torch.models import lm as lm_lib
    batch_ok = B % dp_size == 0 and B >= dp_size

    def f(path, leaf):
        stacked = "stack" in path
        shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
        nd = len(shape)
        bspec = dp_axes if batch_ok else None
        if nd == 4 and shape[1] >= 1024:
            seq = None if batch_ok else "data"
            kv_ok = shape[2] % model_ax == 0
            sp = spmd.Spec(bspec, seq, "model" if kv_ok else None,
                           "model" if (not kv_ok and shape[3] % model_ax == 0)
                           else None)
        elif nd == 4:
            sp = spmd.Spec(bspec, "model" if shape[1] % model_ax == 0
                           else None, None, None)
        elif nd == 3:
            sp = spmd.Spec(bspec, None,
                           "model" if shape[2] % model_ax == 0 else None)
        elif nd == 2:
            sp = spmd.Spec(bspec, "model" if shape[1] % model_ax == 0
                           else None)
        else:
            sp = spmd.Spec()
        return spmd.Spec(None, *sp) if stacked else sp
    return lm_lib.map_with_path(f, cache_shape)


def shard_params(params, model, mesh):
    """Whole parameters (tensors or numpy arrays) cut to this rank's held
    serving shards (:func:`serve_shardings` ``held_params``; the cache's
    shape does not enter them)."""
    from repro_torch.launch import mesh as mesh_lib
    sh = serve_shardings(model, mesh, ServeCfg(batch=1, max_len=1))
    return mesh_lib.shard_tree(params, sh.held_params, mesh)


def local_rows(t, model, B: int):
    """This rank's rows of a batch of ``B`` (split over ``"data"`` where B
    divides, else all of them); ``t`` a tensor, array or scalar (a
    scalar, or anything without B rows, is returned as it is)."""
    ax = model.data_axis
    if ax.size == 1 or B % ax.size or B < ax.size \
            or not hasattr(t, "shape") or len(t.shape) == 0 \
            or t.shape[0] != B:
        return t
    lo, hi = ax.span(B)
    return t[lo:hi]


def jit_prefill(model, mesh, cfg: ServeCfg, with_prefix: bool = False):
    """The sharded prefill: ``(params, masks, tokens (B, S), cache,
    prefix_embeds=None, ties=True) -> (last logits, cache)`` over this
    rank's held ``params`` and ``cache`` (:func:`serve_shardings`).
    ``tokens`` (and ``prefix_embeds``) are the whole batch; the rank takes
    its rows.  The logits are its rows' and its block of the vocabulary
    (``(B / data, V / model)``, the reference's sharded output)."""
    del with_prefix        # a prefix rides on the same function
    tpm = model.on_mesh(mesh)

    def prefill(params, masks, tokens, cache, prefix_embeds=None,
                ties=True):
        if prefix_embeds is not None:
            prefix_embeds = local_rows(prefix_embeds, tpm, cfg.batch)
        logits, cache = tpm.forward(params, masks,
                                    local_rows(tokens, tpm, cfg.batch),
                                    prefix_embeds=prefix_embeds, cache=cache,
                                    cache_len=0, ties=ties)
        return logits[:, -1], cache
    return prefill


def jit_decode_step(model, mesh, cfg: ServeCfg):
    """The sharded greedy decode step: ``(params, masks, token (B, 1),
    cache, cache_len, ties=True) -> (next token (B, 1) int32, cache, last
    logits)``.  ``token`` and a ``(B,)`` ``cache_len`` are the whole
    batch; the rank decodes its rows, takes the argmax over the vocabulary
    split over ``"model"`` (``spmd.argmax``: the first largest) and
    gathers the batch's tokens over ``"data"``, so every rank returns the
    same ``(B, 1)``.  The logits are the rank's (rows, vocabulary
    block)."""
    tpm = model.on_mesh(mesh)

    def decode_step(params, masks, token, cache, cache_len, ties=True):
        logits, cache = tpm.forward(
            params, masks, local_rows(token, tpm, cfg.batch), cache=cache,
            cache_len=local_rows(cache_len, tpm, cfg.batch), ties=ties)
        last = logits[:, -1]
        return greedy_tokens(last, tpm, token.shape[0]), cache, last
    return decode_step


def greedy_tokens(last, model, B: int):
    """``(B, 1)`` int32 greedy tokens of the whole batch, the same on
    every rank, from this rank's (rows, vocabulary block) of last-position
    logits: the argmax over ``"model"`` (``spmd.argmax``, the first
    largest), the rows gathered over ``"data"``."""
    from repro_torch.core import spmd
    nxt = spmd.argmax(last, model.model_axis)
    if nxt.shape[0] != B:
        nxt = spmd.all_gather_dim(nxt, 0, model.data_axis)
    return nxt[:, None].to(torch.int32)


def gather_logits(logits, model, B: int):
    """Whole ``(B, V)`` logits on every rank from each rank's (rows,
    vocabulary block)."""
    from repro_torch.core import spmd
    if model.model_axis.size > 1 and logits.shape[-1] != model.cfg.vocab:
        logits = spmd.all_gather_dim(logits, -1, model.model_axis)
    if logits.shape[0] != B:
        logits = spmd.all_gather_dim(logits, 0, model.data_axis)
    return logits


# ---------------------------------------------------------------- mask sets
#
# Serving multiple ReLU budgets from ONE resident parameter set: every named
# mask set is stacked site-wise into one device tensor
# {site: (n_sets, *site_shape)}, and `select` hands back views of it with
# the shapes of a single mask tree.  Swapping budgets between decode steps
# is therefore an argument substitution: nothing is copied, params
# untouched.


class MaskSetError(ValueError):
    """A mask set cannot be served: its site layout (names/shapes) does not
    match the model, or a checkpointed set failed fingerprint validation."""


@dataclasses.dataclass(frozen=True)
class MaskSetInfo:
    """Provenance + billing identity of one loaded mask set."""

    name: str
    relu_cost: int
    fingerprint: str
    source: str = "inline"


class MaskSetStore:
    """Named, device-resident mask sets over one model's site layout.

    Built from host mask trees (validated against ``site_shapes``), the
    store stacks every site across sets and keeps the stack on ``device``;
    :meth:`select` returns per-set views shaped exactly like a single mask
    tree, so the serving loop swaps ReLU budgets between decode steps
    without a copy.
    """

    def __init__(self, site_shapes: Dict[str, Tuple[int, ...]],
                 sets: Dict[str, M.MaskTree],
                 sources: Optional[Dict[str, str]] = None, device="cuda"):
        """Validate each set's layout against ``site_shapes`` and stack.

        ``site_shapes``: the model's mask-site layout (e.g. ``{k: s.shape
        for k, s in model.mask_sites().items()}``).  ``sets``: name -> host
        mask tree.  Raises :class:`MaskSetError` naming every missing /
        extra / mis-shaped site, so a checkpoint from a different model
        fails loudly instead of serving garbage.
        """
        if not sets:
            raise MaskSetError("MaskSetStore needs at least one mask set")
        self.site_shapes = dict(site_shapes)
        self._names = list(sets.keys())
        self._index = {n: i for i, n in enumerate(self._names)}
        self._infos: Dict[str, MaskSetInfo] = {}
        self._host: Dict[str, M.MaskTree] = {}
        sources = sources or {}
        for name, tree in sets.items():
            problems = validate_site_layout(site_shapes, tree)
            if problems:
                raise MaskSetError(
                    f"mask set {name!r} does not match the model's site "
                    f"layout: " + "; ".join(problems))
            host = {k: np.asarray(v, dtype=np.float32)
                    for k, v in tree.items()}
            self._host[name] = host
            self._infos[name] = MaskSetInfo(
                name=name, relu_cost=M.relu_cost(host),
                fingerprint=M.fingerprint(host),
                source=sources.get(name, "inline"))
        self._stacked = {
            k: torch.from_numpy(np.stack([self._host[n][k]
                                          for n in self._names])).to(device)
            for k in sorted(site_shapes)}

    @property
    def names(self) -> Tuple[str, ...]:
        """Set names in insertion order."""
        return tuple(self._names)

    def select(self, name: str) -> Dict[str, torch.Tensor]:
        """Device mask tree for ``name`` — views of the resident stack."""
        i = self._index[name]
        return {k: v[i] for k, v in self._stacked.items()}

    def host(self, name: str) -> M.MaskTree:
        """Host (numpy) copy of the named set, for billing/inspection."""
        return {k: v.copy() for k, v in self._host[name].items()}

    def info(self, name: str) -> MaskSetInfo:
        """Provenance + billing identity of the named set."""
        return self._infos[name]

    def verify(self, name: str, observed: Optional[str] = None) -> str:
        """Re-fingerprint the named set against its load-time provenance.

        Recomputes the host tree's sha256 and compares it to the
        fingerprint recorded when the set entered the store; returns the
        verified fingerprint or raises :class:`MaskSetError` on mismatch
        (refuse to serve and bill a set whose identity cannot be proven).
        ``observed`` substitutes the recomputed value — the serving tier's
        fault-injection surface (``launch.faults`` corrupts it to drill the
        retry/degrade path).
        """
        want = self._infos[name].fingerprint
        got = observed if observed is not None \
            else M.fingerprint(self._host[name])
        if got != want:
            raise MaskSetError(
                f"mask set {name!r} fails fingerprint verification: "
                f"provenance says {want[:12]}…, observed {got[:12]}… — "
                "refusing to serve it")
        return want

    def cheaper_sets(self, name: str) -> Tuple[str, ...]:
        """Stored set names strictly cheaper (fewer billable ReLUs) than
        ``name``, most expensive first — the natural degradation order."""
        cost = self._infos[name].relu_cost
        below = [n for n in self._names if self._infos[n].relu_cost < cost]
        return tuple(sorted(below, key=lambda n: -self._infos[n].relu_cost))

    def pi_cost_per_token(self, name: str,
                          proto: pi_cost.PIProtocol = pi_cost.PIProtocol()
                          ) -> pi_cost.PICost:
        """PI protocol cost of ONE token's forward under the named set."""
        return pi_cost.cost_of_masks(self._host[name],
                                     len(self.site_shapes), proto)

    @classmethod
    def from_run_dir(cls, run_dir: str,
                     site_shapes: Dict[str, Tuple[int, ...]],
                     names: Optional[Sequence[str]] = None,
                     device="cuda") -> "MaskSetStore":
        """Load every completed sweep stage's ``final/`` masks as a set.

        ``run_dir`` is a sweep output directory (``launch.sweep``, the
        reference's format); each ``stage_*_b<B>/final`` stage-init
        checkpoint becomes the set ``"b<B>"``.  Every loaded tree is
        re-fingerprinted and compared to the fingerprint recorded in the
        checkpoint manifest at save time — a mismatch (bit rot, wrong
        model, hand-edited files) raises :class:`MaskSetError` instead of
        silently serving the wrong budget.  ``names`` optionally restricts
        which sets load.
        """
        from repro_torch.core import runner as runner_lib
        stage_dirs = sorted(
            d for d in glob.glob(os.path.join(run_dir, "stage_*_b*"))
            if os.path.isdir(os.path.join(d, "final")))
        if not stage_dirs:
            raise MaskSetError(
                f"no completed sweep stages (stage_*_b*/final) under "
                f"{run_dir!r} — run a sweep first, or pass explicit mask "
                "sets")
        template = M.full_masks(site_shapes)
        sets: Dict[str, M.MaskTree] = {}
        sources: Dict[str, str] = {}
        for d in stage_dirs:
            m = re.search(r"_b(\d+)$", os.path.basename(d))
            name = f"b{m.group(1)}" if m else os.path.basename(d)
            if names is not None and name not in names:
                continue
            final = os.path.join(d, "final")
            try:
                init = runner_lib.load_stage_init(final, template,
                                                  masks_only=True,
                                                  device="cpu")
            except runner_lib.CheckpointError as e:
                raise MaskSetError(
                    f"stage checkpoint {final!r} cannot be loaded as a "
                    f"mask set (its site layout likely mismatches this "
                    f"model's {sorted(site_shapes)}): {e}") from e
            masks = init["masks"]
            problems = validate_site_layout(site_shapes, masks)
            if problems:
                raise MaskSetError(
                    f"stage checkpoint {final!r} was saved for a different "
                    f"site layout than this model: " + "; ".join(problems))
            want = init.get("meta", {}).get("mask_fingerprint")
            got = M.fingerprint(masks)
            if want and got != want:
                raise MaskSetError(
                    f"mask set {name!r} from {final!r} fails fingerprint "
                    f"validation: manifest says {want[:12]}…, loaded tree "
                    f"hashes {got[:12]}… — refusing to serve it")
            sets[name] = masks
            sources[name] = final
        if names is not None:
            missing = [n for n in names if n not in sets]
            if missing:
                raise MaskSetError(
                    f"requested mask set(s) {missing} not found under "
                    f"{run_dir!r} (have: {sorted(sets)})")
        return cls(site_shapes, sets, sources, device=device)


def validate_site_layout(site_shapes: Dict[str, Tuple[int, ...]],
                         tree: M.MaskTree) -> list:
    """Human-readable mismatches between a mask tree and a site layout.

    Returns one string per problem (missing site, extra site, wrong shape)
    — empty list means the tree is servable on this model.
    """
    problems = []
    for k in sorted(set(site_shapes) - set(tree)):
        problems.append(f"missing site {k!r}")
    for k in sorted(set(tree) - set(site_shapes)):
        problems.append(f"unknown site {k!r}")
    for k in sorted(set(site_shapes) & set(tree)):
        want, got = tuple(site_shapes[k]), tuple(np.shape(tree[k]))
        if want != got:
            problems.append(f"site {k!r}: model wants {want}, set has {got}")
    return problems


# ------------------------------------------------------ slot cache surgery
#
# Prefill/decode disaggregation: prefill runs on a (1, P) batch with its own
# B=1 cache, then the result is copied into one slot of the resident decode
# cache.  Stack-level cache leaves carry a leading repeats axis, so the
# batch axis is 1 there and 0 everywhere else.


def _pairs(big, small, stacked=False):
    """(decode-cache leaf, prefill-cache leaf, batch axis) for every leaf
    of two cache trees of the same structure."""
    if isinstance(big, dict):
        for k in big:
            yield from _pairs(big[k], small[k], stacked or k == "stack")
    elif isinstance(big, (list, tuple)):
        for b, s in zip(big, small):
            yield from _pairs(b, s, stacked)
    else:
        yield big, small, 1 if stacked else 0


def make_insert_slot(model):
    """Function copying a B=1 prefill cache into slot ``i`` of a decode
    cache, in place: ``insert(big, small, i) -> big``.  ``small`` is only
    read, and no leaf of ``big`` comes to alias it, so the prefill cache
    can be refilled for the next request."""
    del model   # the tree structure alone decides the batch axis

    def insert(big, small, i):
        for b, s, ax in _pairs(big, small):
            b.select(ax, int(i)).copy_(s.select(ax, 0))
        return big
    return insert


def read_slot_tokens(tokens, live: np.ndarray) -> np.ndarray:
    """Host view of a (B, 1) token batch, ``-1`` where not live."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    out = np.asarray(tokens).reshape(-1).copy()
    out[~live] = -1
    return out
