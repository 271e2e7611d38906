"""Mask ↔ model glue: declares *mask sites* and applies masked activations.

Counterpart of ``repro/core/linearize.py``.  A model exposes
``mask_sites() -> {name: MaskSite}``; the linearization engine builds the
mask tree, and the model's forward applies ``apply_masked_act`` at each
site.  BCD only ever sees the mask tree.

PyTorch runs eagerly, so nothing here is a trace-time hint: whether a gate
is folded into the next convolution is the plain ``fused`` argument of the
model's forward, and the candidate axis is an explicit leading dimension of
the mask (and, once candidates differ, of the activation).

**The candidate axis begins where the candidates differ.**  Evaluators hand
a stacked chunk's forward a host decision, :func:`first_differences`; a
model applies the gate of a site (or of a stack repeat) that every
candidate shares with the one mask (:func:`shared_mask`) while its
activation is still shared, so every layer before the first differing gate
runs at B rows, as a cached prefix does, and its products run at the same
shapes whichever engine computes them.  A chunk whose candidates are all
equal runs once and its accuracy is each candidate's
(:func:`per_candidate`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from . import masks as M

# Activation kinds with a masked lowering (plain version + CUDA kernels).
KINDS = ("relu", "gelu", "silu", "sqrelu")
REPLACEMENTS = ("identity", "poly2")


@dataclasses.dataclass(frozen=True)
class MaskSite:
    """One maskable nonlinearity site.

    shape: the mask shape (shared over batch / sequence).  CNNs use the full
    (H, W, C) activation-site shape (paper's per-pixel masks).
    kind:  activation at the site ('relu' | 'gelu' | 'silu' | 'sqrelu').
    replacement: 'identity' (Network Linearization) or 'poly2' (AutoReP).

    Validated at registration, so a typo'd kind does not surface deep inside
    the kernel dispatch of whichever backend first evaluates the site.
    """
    shape: Tuple[int, ...]
    kind: str = "relu"
    replacement: str = "identity"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown activation kind {self.kind!r} (one of {KINDS})")
        if self.replacement not in REPLACEMENTS:
            raise ValueError(
                f"unknown replacement {self.replacement!r} "
                f"(one of {REPLACEMENTS})")
        if not self.shape or any(int(d) <= 0 for d in self.shape):
            raise ValueError(f"mask shape must be non-empty positive dims, "
                             f"got {self.shape!r}")


def init_masks(sites: Dict[str, MaskSite]) -> M.MaskTree:
    return M.full_masks({k: s.shape for k, s in sites.items()})


def init_poly(sites: Dict[str, MaskSite], device="cuda"
              ) -> Dict[str, torch.Tensor]:
    """AutoReP poly2 coefficients per site, initialized near identity:
    g(x) = 0·x² + 1·x + 0."""
    out = {}
    for k, s in sites.items():
        if s.replacement == "poly2":
            p = torch.zeros((3,) + tuple(s.shape), dtype=torch.float32,
                            device=device)
            p[1] = 1.0
            out[k] = p
    return out


def has_share_ties(masks) -> bool:
    """Host-side test: does a numpy mask tree (stacked or not) carry any
    share-tied coordinate (``masks.TIE``)?  Evaluators call this on the
    host copy of a chunk and hand the answer to the forward as ``ties=``,
    so that tie-free chunks skip :func:`_apply_share_ties` without a device
    read."""
    for v in masks.values():
        v = np.asarray(v)
        if np.any((v > 0.5) & (v < 0.9)):
            return True
    return False


def first_differences(stacked) -> Dict[str, Optional[int]]:
    """Host-side decision for a stacked numpy mask tree: for each key, None
    where the N candidates' masks are all equal, else the first index along
    the axis after the candidate axis at which they differ — for a stack
    site, whose leaves are ``(N, R, *shape)``, the first repeat that
    differs.  Evaluators compute it on the host copy of a chunk and hand it
    to the forward as ``differ=``, as they hand it ``ties=``: nothing is
    read back from the device."""
    out = {}
    for k, v in stacked.items():
        v = np.asarray(v)
        rows = np.flatnonzero(
            (v != v[:1]).reshape(v.shape[0], v.shape[1], -1).any(axis=(0, 2)))
        out[k] = int(rows[0]) if rows.size else None
    return out


def shared_mask(mask, differ, name: str, repeat=None):
    """The one mask ``mask[0]`` of a stacked leaf where the decision
    ``differ`` (:func:`first_differences`) says every candidate has the same
    mask at ``name`` — at stack repeat ``repeat`` for a leaf with a repeat
    axis, which the candidates share before their first differing repeat;
    otherwise ``mask`` as it is.  A model calls it while the gate's input
    is still shared by the candidates, so the gate's output stays
    un-stacked.  ``differ=None`` (no decision) keeps every stacked mask."""
    if differ is None or name not in differ:
        return mask
    first = differ[name]
    if first is None or (repeat is not None and repeat < first):
        return mask[0]
    return mask


def per_candidate(acc, masks, differ):
    """A stacked chunk's ``(N,)`` accuracies: where no gate differed the
    forward ran once, un-stacked, and its 0-d accuracy is each
    candidate's."""
    if differ is None or acc.dim() > 0:
        return acc
    n = next(iter(masks.values())).shape[0]
    return acc.reshape(1).expand(n).contiguous()


def _apply_share_ties(x, mask, out):
    """Override share-tied coordinates (``masks.TIE``) in a hard-masked
    activation output.

    A tied coordinate keeps its gate but reuses the *sign decision* of its
    leader — the previous coordinate along the site's last axis (one
    garbled-circuit comparison serves both coordinates in the PI protocol,
    which is why ``masks.relu_cost`` does not bill ties).
    ``out = x * H(x_leader)`` where H is the Heaviside step on the leader's
    pre-activation.  Binary masks make ``tied`` all-False and the ``where``
    selects ``out`` everywhere.

    Eagerly this is four more passes over the activation, so callers that
    know from the host mask tree that nothing is tied pass ``ties=False``
    to :func:`apply_masked_act` and never get here.  The fused gate→conv
    and gate→matmul kernels do not implement the override: a chunk with
    ties runs unfused.
    """
    tied = (mask > 0.5) & (mask < 0.9)
    drv = (torch.roll(x, 1, dims=-1) > 0).to(x.dtype)
    return torch.where(tied, x * drv, out)


def apply_masked_act(x, mask, site: MaskSite, poly=None, soft: bool = False,
                     ties: bool = True):
    """Apply the (possibly soft, for SNL) masked activation at a site.

    mask: ``site.shape`` for one mask tree, or ``(N, *site.shape)`` for N
    stacked candidates.  x: ``(batch, *site.shape)``, or
    ``(N, batch, *site.shape)`` once the candidates' activations differ; an
    un-stacked x under a stacked mask is shared by the candidates and the
    result is stacked.  An LM site's x has a sequence axis as well,
    ``(N, batch, seq, *site.shape)``, where a shared one comes as an
    ``expand``-ed stride-0 view (``(batch, seq, *site)`` alone would read as
    stacked).

    soft=True keeps real-valued masks differentiable (SNL's relaxation);
    hard masks route through the kernel wrappers, and an un-stacked hard
    gate under autograd through ``ops.MaskedActFn`` (its backward is the
    hand-written ``gate_bwd_kernel`` on the card).  Hard masks may carry
    share-tied coordinates (``masks.TIE``), overridden by
    :func:`_apply_share_ties` unless the caller knows there are none
    (``ties=False``); soft mode treats every real value as an SNL relaxation
    weight and never ties.
    """
    nd = len(site.shape)
    stacked_mask = mask.dim() == nd + 1
    if mask.dim() not in (nd, nd + 1) or \
            tuple(mask.shape[-nd:]) != tuple(site.shape):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit site "
                         f"{site.shape}")
    p = None
    if poly is not None and (soft or site.replacement == "poly2"):
        p = poly
    # mask laid out to broadcast against x: (N, 1, ..., *site) when stacked,
    # with as many 1s as x has axes between the candidate axis and the site
    # (a CNN's batch; an LM's batch and sequence)
    m_b = mask
    if stacked_mask:
        lead = max(x.dim() - 1 - nd, 1)
        m_b = mask.reshape((mask.shape[0],) + (1,) * lead + tuple(site.shape))
    if soft:
        # plain ops, differentiable; the clip's derivative is 1/2 on its
        # bounds, where SNL's weights sit, as in the reference
        return ref.masked_act_ref(x, ref.tie_clamp(m_b, 0.0, 1.0),
                                  kind=site.kind, poly=p)
    if stacked_mask:
        out = ops.masked_act_sited_batched(x, mask, kind=site.kind, poly=p)
    else:
        # one mask for everything in x: with per-candidate activations the
        # candidate and batch axes both fold into the kernel's rows
        out = ops.masked_act_sited(x, mask, kind=site.kind, poly=p)
    if not ties:
        return out
    return _apply_share_ties(x, m_b, out)
