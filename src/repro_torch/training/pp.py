"""Optional pipeline parallelism: the GPipe microbatch schedule.

Counterpart of ``repro/training/pp.py``.  The canonical skew schedule over
clock ticks with one buffer per stage:

    tick t: shift microbatch t into stage 0, run EVERY stage on its
            buffer, emit stage S-1's output.

The reference runs the stages of a tick with ``jax.vmap`` over a stacked
stage axis (which a ``"stage"`` mesh axis would shard).  The port writes the
stage axis out, a loop over the stages, as it writes every candidate axis
(no ``vmap``); the schedule is a plain Python loop, so the result is
differentiable through autograd.  Bubble ticks run the stages on zeros, as
the reference's do, and their outputs are dropped.  The bubble fraction is
(S-1)/(M+S-1).
"""
from __future__ import annotations

from typing import Callable

import torch


def _stage(tree, s: int):
    """Stage ``s`` of a tree whose every leaf has a leading stage axis."""
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, s) for v in tree)
    return tree[s]


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def gpipe_forward(body: Callable, stage_params, micro_inputs: torch.Tensor
                  ) -> torch.Tensor:
    """Run ``micro_inputs`` through a pipeline of homogeneous stages.

    body:          (stage_param_tree, x) -> y   (one stage's forward)
    stage_params:  tree with a leading stage axis S on every leaf
    micro_inputs:  (M, micro_batch, ...) — M microbatches
    Returns (M, micro_batch, ...) outputs, equal to applying the S stages
    in turn to each microbatch.
    """
    n_stages = _first_leaf(stage_params).shape[0]
    n_micro = micro_inputs.shape[0]
    zero = torch.zeros_like(micro_inputs[0])
    state = [zero] * n_stages
    params = [_stage(stage_params, s) for s in range(n_stages)]
    out = []
    for t in range(n_micro + n_stages - 1):
        inp = micro_inputs[t] if t < n_micro else zero
        shifted = [inp] + state[:-1]
        state = [body(params[s], shifted[s]) for s in range(n_stages)]
        out.append(state[-1])
    return torch.stack(out[n_stages - 1:])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule — the classic (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
