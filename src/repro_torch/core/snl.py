"""SNL — Selective Network Linearization (Cho et al., ICML 2022).

Counterpart of ``repro/core/snl.py``.  The paper's main baseline and the
starting point of BCD (the B_ref checkpoint): learns real-valued per-site
mask weights α jointly with θ under ``CE + λ·‖α‖₁`` (the L1 relaxation of
Eq. 1), with the ``λ ← κ·λ`` correction when sparsification stalls, then
hard-thresholds to the target budget and finetunes — the "threshold
cliff" that motivates BCD.

Derivatives at ties are JAX's (``kernels/ref.py``): ``|α|′(0) = 1`` in the
L1 term and 1/2 where α sits on a bound of the soft gate's clip, which is
where most α sit after each step's clip back to [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.convert import to_device
from repro_torch.kernels import ref
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train import deterministic, loss_and_grads
from . import masks as M


@dataclasses.dataclass
class SNLConfig:
    b_target: int
    lam0: float = 1e-4            # initial lasso coefficient λ₀
    kappa: float = 1.2            # λ ← κ·λ when sparsification stalls
    stall_delta: int = 0          # "stalled" = fewer ReLUs dropped than this
    alpha_threshold: float = 1e-2  # binarization threshold for budget counting
    epochs: int = 30
    steps_per_epoch: int = 20
    lr: float = 1e-3
    finetune_steps: int = 100
    seed: int = 0


@dataclasses.dataclass
class SNLResult:
    params: object
    masks: M.MaskTree             # hard binary masks at exactly b_target
    alphas: Dict[str, np.ndarray]  # final soft masks (pre-threshold)
    snapshots: List[M.MaskTree]   # binarized masks per epoch (Fig. 6 analysis)
    budget_per_epoch: List[int]
    lam_per_epoch: List[float]

    def stage_init(self) -> dict:
        """This result as a BCD warm-start (the paper's B_ref checkpoint):
        ``{kind, masks, params, aux}``, the layout AutoReP's result shares,
        so a budget sweep can descend from either."""
        return {"kind": "snl", "masks": self.masks, "params": self.params,
                "aux": {"alphas": self.alphas}}


def run_snl(
    params,
    alphas: Dict[str, object],
    loss_fn: Callable,    # (params, alphas, batch, soft) -> (loss, acc)
    batches: Callable[[int], object],   # step -> batch
    cfg: SNLConfig,
    *,
    verbose: bool = False,
    device="cuda",
) -> SNLResult:
    """Soft training of (θ, α), the budget per epoch, then ``M.threshold``
    to exactly ``cfg.b_target`` and :func:`finetune` under the hard masks.
    ``params``, ``alphas`` and each ``batches(i)`` are moved to ``device``
    (numpy or tensors)."""
    opt = opt_lib.sgd(lr=cfg.lr, momentum=0.9,
                      schedule=opt_lib.cosine(cfg.lr, cfg.epochs *
                                              cfg.steps_per_epoch))

    def train_loss(both, batch, lam):
        p, a = both
        loss, _acc = loss_fn(p, a, batch, True)
        l1 = sum(torch.sum(ref.abs_tie(v)) for v in a.values())
        return loss + lam * l1

    with deterministic():
        # (θ, α) as one list of leaves, θ's first, stepped in place
        like = (to_device(params, device), to_device(dict(alphas), device))
        leaves = opt_lib.tree_leaves(like)
        n_theta = len(opt_lib.tree_leaves(like[0]))
        ostate = opt.init(leaves)
        both = like
        lam = cfg.lam0
        snapshots, budgets, lams = [], [], []
        prev_budget = None
        it = 0
        for epoch in range(cfg.epochs):
            for _ in range(cfg.steps_per_epoch):
                grads = _grad_leaves(train_loss, like, leaves,
                                     to_device(batches(it), device), lam)
                leaves, ostate = opt_lib.step_leaves(opt, grads, ostate,
                                                     leaves)
                for i in range(n_theta, len(leaves)):
                    leaves[i] = torch.clamp(leaves[i], 0.0, 1.0)
                it += 1
            both = opt_lib.tree_unflatten(like, leaves)
            a_host = {k: v.cpu().numpy() for k, v in both[1].items()}
            hard = {k: (v > cfg.alpha_threshold).astype(np.float32)
                    for k, v in a_host.items()}
            budget = M.count(hard)
            snapshots.append(hard)
            budgets.append(budget)
            lams.append(lam)
            if verbose:
                print(f"[snl] epoch={epoch} budget={budget} lam={lam:.2e}")
            if budget <= cfg.b_target:
                break
            if prev_budget is not None and \
                    prev_budget - budget <= cfg.stall_delta:
                lam *= cfg.kappa          # the κ correction mechanism
            prev_budget = budget

        # Hard threshold to EXACTLY b_target (the step that costs accuracy).
        a_host = {k: v.cpu().numpy() for k, v in both[1].items()}
        hard = M.threshold(a_host, cfg.b_target)

        # Finetune θ with binarized masks.
        theta = both[0]
        del like, leaves, ostate, both
        params = finetune(theta, hard, loss_fn, batches,
                          steps=cfg.finetune_steps, lr=cfg.lr,
                          start_step=it, device=device)
    return SNLResult(params, hard, a_host, snapshots, budgets, lams)


def _grad_leaves(fn, like, leaves, *args) -> list:
    """The gradient leaves of ``fn(tree, *args)`` at ``leaves`` laid out as
    ``like``, with nothing of the forward kept alive afterwards."""
    tree = opt_lib.tree_unflatten(like, leaves)
    return opt_lib.tree_leaves(loss_and_grads(fn, tree, *args)[1])


def finetune(params, hard_masks: M.MaskTree, loss_fn, batches,
             *, steps: int, lr: float = 1e-3, start_step: int = 0,
             use_adam: bool = False, device="cuda"):
    """Finetune θ under fixed binary masks (shared by SNL / BCD / AutoReP):
    SGD with momentum 0.9, or AdamW, on a cosine schedule over ``steps``.
    ``loss_fn(params, masks, batch, soft=False) -> (loss, ...)``; the hard
    gate's gradient goes through ``kernels.ops.MaskedActFn``.  Returns new
    parameters; deterministic (:func:`training.train.deterministic`).
    Steps leaf by leaf (``optimizer.step_leaves``): the peak is the
    parameters passed in, the ones being trained, their gradients and the
    moments — what a 3 B-parameter model in float32 needs on one card."""
    opt = (opt_lib.adamw(lr=lr, schedule=opt_lib.cosine(lr, steps))
           if use_adam else
           opt_lib.sgd(lr=lr, momentum=0.9,
                       schedule=opt_lib.cosine(lr, steps)))
    masks_dev = M.as_device(hard_masks, device)

    def loss(p, batch):
        return loss_fn(p, masks_dev, batch, False)[0]

    with deterministic():
        like = to_device(params, device)
        leaves = opt_lib.tree_leaves(like)
        ostate = opt.init(leaves)
        for i in range(steps):
            batch = to_device(batches(start_step + i), device)
            grads = _grad_leaves(loss, like, leaves, batch)
            leaves, ostate = opt_lib.step_leaves(opt, grads, ostate, leaves)
    return opt_lib.tree_unflatten(like, leaves)
