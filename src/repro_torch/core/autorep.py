"""AutoReP — Automatic ReLU Replacement (Peng et al., ICCV 2023), simplified.

Counterpart of ``repro/core/autorep.py``.  The second Selective baseline
the paper composes with.  Differences from SNL:
(1) eliminated ReLUs are replaced by a *learnable degree-2 polynomial*
    g(x) = a·x² + b·x + c (per-site coefficients, initialized to identity),
    learned jointly with θ;
(2) the binary indicator m = 1[α > 0] is trained with a straight-through
    estimator stabilized by a *hysteresis loop*: m flips 1→0 only when
    α < −h and 0→1 only when α > +h;
(3) the budget is soft-enforced by a penalty on the active fraction.

Final masks are hard top-|B| selections over α, followed by an AdamW
finetune of (θ, poly) under the fixed masks.  The indicator's values are 0
or 1, so every one sits on a bound of the soft gate's clip, whose
derivative there is 1/2 as in the reference (``kernels/ref.py``).
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
class AutoRepConfig:
    b_target: int
    hysteresis: float = 0.05
    budget_weight: float = 1.0     # λ on the budget penalty
    epochs: int = 30
    steps_per_epoch: int = 20
    lr: float = 1e-3
    finetune_steps: int = 100
    seed: int = 0


@dataclasses.dataclass
class AutoRepResult:
    params: object
    poly: Dict[str, torch.Tensor]
    masks: M.MaskTree
    alphas: Dict[str, np.ndarray]
    budget_per_epoch: List[int]

    def stage_init(self) -> dict:
        """This result as a BCD warm-start, in the layout of
        ``SNLResult.stage_init``: the poly coefficients ride in ``aux`` so
        a stage finetuning (θ, poly) can restore them beside θ."""
        return {"kind": "autorep", "masks": self.masks,
                "params": self.params, "aux": {"poly": self.poly}}


def _ste_indicator(alpha, m_prev, h):
    """Hysteresis indicator with a straight-through gradient
    (d m / d alpha := 1)."""
    up = (alpha > h).to(torch.float32)
    down = (alpha >= -h).to(torch.float32)
    m = torch.where(m_prev > 0.5, down, up)
    return m + alpha - alpha.detach()


def soft_step(loss_fn: Callable, cfg: AutoRepConfig, total: int):
    """The soft phase's optimizer and step: ``step(trainable, m_prev,
    ostate, batch) -> (trainable, m_hard, ostate)`` with trainable
    ``(params, alphas, poly)``; ``total`` counts the mask coordinates."""
    target_frac = cfg.b_target / total
    opt = opt_lib.sgd(lr=cfg.lr, momentum=0.9,
                      schedule=opt_lib.cosine(
                          cfg.lr, cfg.epochs * cfg.steps_per_epoch))

    def train_loss(trainable, m_prev, batch):
        p, a, q = trainable
        m = {k: _ste_indicator(a[k], m_prev[k], cfg.hysteresis) for k in a}
        loss, _acc = loss_fn(p, m, q, batch, True)
        frac = sum(torch.sum(v) for v in m.values()) / total
        budget_pen = ref.abs_tie(frac - target_frac)
        return loss + cfg.budget_weight * budget_pen, m

    def step(trainable, m_prev, ostate, batch):
        (_, m), grads = loss_and_grads(train_loss, trainable, m_prev, batch)
        updates, ostate = opt.update(grads, ostate, trainable)
        trainable = opt_lib.apply_updates(trainable, updates)
        m_hard = {k: (v > 0.5).to(torch.float32) for k, v in m.items()}
        return trainable, m_hard, ostate

    return opt, step


def run_autorep(
    params,
    alphas: Dict[str, object],
    poly: Dict[str, object],
    loss_fn: Callable,   # (params, masks, poly, batch, soft) -> (loss, acc)
    batches: Callable[[int], object],
    cfg: AutoRepConfig,
    *,
    verbose: bool = False,
    device="cuda",
) -> AutoRepResult:
    """Soft STE training of (θ, α, poly) under the budget penalty, the
    budget per epoch, ``M.threshold`` to ``cfg.b_target``, then an AdamW
    finetune at 3.5e-5 of (θ, poly) under the hard masks."""
    total = sum(int(np.prod(v.shape)) for v in alphas.values())
    opt, step = soft_step(loss_fn, cfg, total)

    with deterministic():
        trainable = (to_device(params, device),
                     to_device(dict(alphas), device),
                     to_device(dict(poly), device))
        m_prev = {k: torch.ones_like(v) for k, v in trainable[1].items()}
        ostate = opt.init(trainable)
        budgets, it = [], 0
        for epoch in range(cfg.epochs):
            for _ in range(cfg.steps_per_epoch):
                trainable, m_prev, ostate = step(
                    trainable, m_prev, ostate,
                    to_device(batches(it), device))
                it += 1
            budget = M.count({k: v.cpu().numpy() for k, v in m_prev.items()})
            budgets.append(budget)
            if verbose:
                print(f"[autorep] epoch={epoch} budget={budget}")

        params, a, q = trainable
        a_host = {k: v.cpu().numpy() for k, v in a.items()}
        hard = M.threshold(a_host, cfg.b_target)

        # Finetune (θ, poly) with fixed binary masks.
        masks_dev = M.as_device(hard, device)
        fopt = opt_lib.adamw(lr=3.5e-5, schedule=opt_lib.cosine(
            3.5e-5, cfg.finetune_steps))

        def floss(pq, batch):
            return loss_fn(pq[0], masks_dev, pq[1], batch, False)[0]

        pq = (params, q)
        fstate = fopt.init(pq)
        for i in range(cfg.finetune_steps):
            _, grads = loss_and_grads(floss, pq,
                                      to_device(batches(it + i), device))
            updates, fstate = fopt.update(grads, fstate, pq)
            pq = opt_lib.apply_updates(pq, updates)
    return AutoRepResult(pq[0], pq[1], hard, a_host, budgets)
