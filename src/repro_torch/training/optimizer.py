"""Optimizers without ``torch.optim``: SGD (+momentum) and AdamW, and the
cosine schedule.

Counterpart of ``repro/training/optimizer.py``, with its update rules and
its float32 arithmetic, not ``torch.optim``'s:

  * SGD: ``mu = β·mu + g``, update ``−lr_t·mu`` (``− lr_t·wd·p`` with weight
    decay), ``lr_t = sched(step)`` taken before the step is counted;
  * AdamW: moments ``b1·mu + (1−b1)·g``, ``b2·nu + (1−b2)·g²``, bias
    corrections ``1 − b**step`` with the step already counted;
  * schedules evaluated in float32, as ``jnp`` evaluates them.

API (optax-like, functional — nothing is hidden in the optimizer, nothing
is updated in place)::

    opt = sgd(lr=1e-3, momentum=0.9, schedule=cosine(1e-3, steps))
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameter trees are the port's: nested dicts, lists and tuples of tensors
(as ``convert.params_from_reference`` returns them).  Leaves are visited
in the reference's order, dict keys sorted, so that sums over leaves (the
gradient norm of ``grad_clip``) add in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


# ----------------------------------------------------------------- trees


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, dict keys sorted (as
    ``jax.tree.leaves`` orders them); None holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    as its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


# ------------------------------------------------------------- schedules


def cosine(base_lr: float, total_steps: int, min_lr: float = 0.0):
    """Cosine annealing (Loshchilov & Hutter) — the paper's finetune
    schedule.  ``sched(step)`` is a float32 value (as a Python float)."""
    half = np.float32(0.5 * (base_lr - min_lr))
    pi = np.float32(np.pi)

    def sched(step):
        t = np.float32(min(int(step), total_steps)) / \
            np.float32(max(total_steps, 1))
        return float(np.float32(min_lr) +
                     half * (np.float32(1.0) + np.cos(pi * t)))
    return sched


def constant(lr: float):
    """Constant learning-rate schedule (float32, as a Python float)."""
    value = float(np.float32(lr))
    return lambda step: value


# ------------------------------------------------------------ optimizers


class OptState(NamedTuple):
    """Shared optimizer state (AdamW uses both moments, SGD only mu).
    ``step``: the number of updates taken, a Python int."""

    step: int
    mu: object        # momentum / first moment (tree of tensors)
    nu: object        # second moment (AdamW only; None for SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An (init, update) pair — the optax-style contract."""

    init: Callable
    update: Callable   # (grads, state, params) -> (updates, new_state)


def _zeros_like_tree(params):
    return tree_map(torch.zeros_like, params)


def _f32(x) -> float:
    return float(np.float32(x))


def sgd(lr: float = 1e-3, momentum: float = 0.9,
        schedule: Optional[Callable] = None,
        weight_decay: float = 0.0, grad_clip: Optional[float] = None):
    """SGD with momentum, optional decoupled weight decay and grad clip."""
    sched = schedule or constant(lr)

    def init(params):
        return OptState(0, _zeros_like_tree(params), None)

    def update(grads, state, params):
        grads = _clip(grads, grad_clip)
        lr_t = sched(state.step)
        decay = _f32(np.float32(lr_t) * np.float32(weight_decay))
        mu = tree_map(lambda m, g: m * momentum + g, state.mu, grads)

        def upd(m, p):
            u = m * -lr_t
            if weight_decay:
                u = u - decay * p
            return u.to(p.dtype)
        updates = tree_map(upd, mu, params)
        return updates, OptState(state.step + 1, mu, state.nu)

    return Optimizer(init, update)


def adamw(lr: float = 3.5e-5, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          schedule: Optional[Callable] = None,
          grad_clip: Optional[float] = None):
    """AdamW (decoupled weight decay) with bias correction."""
    sched = schedule or constant(lr)

    def init(params):
        return OptState(0, _zeros_like_tree(params),
                        _zeros_like_tree(params))

    def update(grads, state, params):
        grads = _clip(grads, grad_clip)
        step = state.step + 1
        lr_t = sched(state.step)
        decay = _f32(np.float32(lr_t) * np.float32(weight_decay))
        mu = tree_map(lambda m, g: m * b1 + g.to(m.dtype) * (1 - b1),
                      state.mu, grads)
        nu = tree_map(lambda n, g: n * b2 + torch.square(g.to(n.dtype)) *
                      (1 - b2), state.nu, grads)
        bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
        bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)

        def upd(m, n, p):
            # divide by tensors: a CUDA division by a Python number is a
            # product with its reciprocal, which rounds twice
            c1 = torch.full((), float(bc1), dtype=m.dtype, device=m.device)
            c2 = torch.full((), float(bc2), dtype=n.dtype, device=n.device)
            u = (m / c1) * -lr_t / (torch.sqrt(n / c2) + eps)
            if weight_decay:
                u = u - decay * p
            return u.to(p.dtype)
        updates = tree_map(upd, mu, nu, params)
        return updates, OptState(step, mu, nu)

    return Optimizer(init, update)


def _clip(grads, max_norm):
    if not max_norm:
        return grads
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp_max(torch.full_like(gn, max_norm) / (gn + 1e-9),
                            1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def apply_updates(params, updates):
    """Apply additive updates leaf-wise (optax-style); new tensors, the
    inputs are left as they are."""
    return tree_map(lambda p, u: p + u, params, updates)
