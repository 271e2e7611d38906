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

and, for a model whose parameters, gradients and moments fill the card,
the same step leaf by leaf on lists of leaves (:func:`step_leaves`): each
leaf's moments are updated in place, its new parameter replaces the old
one and its gradient is dropped, as soon as they are made — the same
arithmetic, the same bits::

    leaves = tree_leaves(params)
    state = opt.init(leaves)
    leaves, state = step_leaves(opt, tree_leaves(grads), state, leaves)

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
    return _build(like, iter(leaves))


def _build(t, it):
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, which would keep every leaf it
    # saw alive until the garbage collector runs (on the card, whole
    # parameter trees)
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    if t is None:
        return None
    return next(it)


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
    """An (init, update) pair — the optax-style contract — and the rule it
    is made of: ``prepare(grads, state)`` gives the step's values (the
    learning rate, the gradient clip's scale), ``leaf(ctx, g, m, n, p,
    owned=False)`` one leaf's ``(update, new m, new n)`` (n is None for
    SGD), with ``owned`` writing the new moments over m and n."""

    init: Callable
    update: Callable   # (grads, state, params) -> (updates, new_state)
    prepare: Callable
    leaf: Callable


def _tree_update(prepare, leaf):
    """``update`` over whole trees, from the per-leaf rule."""
    def update(grads, state, params):
        ctx = prepare(grads, state)
        nus = tree_leaves(state.nu) if state.nu is not None else \
            [None] * len(tree_leaves(params))
        out = [leaf(ctx, g, m, n, p) for g, m, n, p in zip(
            tree_leaves(grads), tree_leaves(state.mu), nus,
            tree_leaves(params))]
        updates = tree_unflatten(params, [o[0] for o in out])
        mu = tree_unflatten(state.mu, [o[1] for o in out])
        nu = None if state.nu is None else \
            tree_unflatten(state.nu, [o[2] for o in out])
        return updates, OptState(state.step + 1, mu, nu)
    return update


def step_leaves(opt: Optimizer, grads: list, state: OptState,
                params: list):
    """One step of ``opt`` on lists of leaves (:func:`tree_leaves` order),
    **in place**: leaf by leaf, the moments in ``state.mu`` / ``state.nu``
    (lists from ``opt.init`` of a list, which the step owns) are updated
    where they lie, the new parameter replaces the old one in ``params``
    and the gradient's entry in ``grads`` becomes None, as soon as each is
    made.  The peak is then the parameters, gradients and moments and a
    few of one leaf's temporaries, not a second copy of each tree.  The
    arithmetic is ``opt.update`` followed by :func:`apply_updates`, bit
    for bit.  Returns ``(params, new_state)``: the same lists."""
    ctx = opt.prepare(grads, state)
    mu, nu = state.mu, state.nu
    for i in range(len(params)):
        u, _, _ = opt.leaf(ctx, grads[i], mu[i],
                           None if nu is None else nu[i], params[i],
                           owned=True)
        grads[i] = None
        params[i] = params[i] + u
        del u
    return params, OptState(state.step + 1, mu, nu)


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

    def prepare(grads, state):
        lr_t = sched(state.step)
        return (_clip_scale(grads, grad_clip), lr_t,
                _f32(np.float32(lr_t) * np.float32(weight_decay)))

    def leaf(ctx, g, m, n, p, owned=False):
        scale, lr_t, decay = ctx
        m = m.mul_(momentum) if owned else m * momentum
        m += _clip(g, scale)
        u = m * -lr_t
        if weight_decay:
            u -= decay * p
        return u.to(p.dtype), m, None

    return Optimizer(init, _tree_update(prepare, leaf), prepare, leaf)


def adamw(lr: float = 3.5e-5, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          schedule: Optional[Callable] = None,
          grad_clip: Optional[float] = None):
    """AdamW (decoupled weight decay) with bias correction."""
    sched = schedule or constant(lr)

    def init(params):
        return OptState(0, _zeros_like_tree(params),
                        _zeros_like_tree(params))

    def prepare(grads, state):
        step = state.step + 1
        lr_t = sched(state.step)
        return (_clip_scale(grads, grad_clip), lr_t,
                _f32(np.float32(lr_t) * np.float32(weight_decay)),
                np.float32(1.0) - np.float32(b1) ** np.float32(step),
                np.float32(1.0) - np.float32(b2) ** np.float32(step))

    def leaf(ctx, g, m, n, p, owned=False):
        # m·b1 + g·(1 − b1), n·b2 + g²·(1 − b2), then (m / c1)·(−lr) /
        # (√(n / c2) + eps): each operation as one product or sum, in this
        # order, so the in-place forms round as the plain ones do
        scale, lr_t, decay, bc1, bc2 = ctx
        g = _clip(g, scale)
        m = m.mul_(b1) if owned else m * b1
        m += g.to(m.dtype) * (1 - b1)
        t = torch.square(g.to(n.dtype))
        t *= 1 - b2
        n = n.mul_(b2) if owned else n * b2
        n += t
        del g, t
        # divide by tensors: a CUDA division by a Python number is a
        # product with its reciprocal, which rounds twice
        c1 = torch.full((), float(bc1), dtype=m.dtype, device=m.device)
        c2 = torch.full((), float(bc2), dtype=n.dtype, device=n.device)
        u = m / c1
        u *= -lr_t
        den = n / c2
        den.sqrt_()
        den += eps
        u /= den
        del den
        if weight_decay:
            u -= decay * p
        return u.to(p.dtype), m, n

    return Optimizer(init, _tree_update(prepare, leaf), prepare, leaf)


def _clip_scale(grads, max_norm):
    """The gradient clip's factor (a 0-d tensor), or None without a clip:
    the global norm over every leaf, in :func:`tree_leaves` order."""
    if not max_norm:
        return None
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    return torch.clamp_max(torch.full_like(gn, max_norm) / (gn + 1e-9), 1.0)


def _clip(g, scale):
    return g if scale is None else g * scale.to(g.dtype)


def apply_updates(params, updates):
    """Apply additive updates leaf-wise (optax-style); new tensors, the
    inputs are left as they are."""
    return tree_map(lambda p, u: p + u, params, updates)
