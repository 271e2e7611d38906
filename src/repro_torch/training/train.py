"""The CNN train step, its loss, and an accuracy closure for BCD.

Counterpart of the CNN part of ``repro/training/train.py``
(``cross_entropy``, ``make_cnn_train_step``, ``make_eval_acc``); the LM
step, ``quantize_grads_int8`` and the sharded step factory are not ported
yet.

A step differentiates with ``torch.autograd.grad`` with respect to the
parameter leaves (:func:`loss_and_grads`), updates with
``training.optimizer`` and returns new trees: nothing is updated in place.
BatchNorm uses batch statistics in training as in evaluation
(``models/resnet.py``).  The hard-mask gate is differentiable through
``kernels.ops.MaskedActFn`` (its backward is ``gate_bwd_kernel`` on the
card); the forward runs unfused (``fused=False``), as the fused kernels
have no backward.

Training entry points run under :func:`deterministic` — cuDNN's
deterministic algorithms, no autotuning — so that a finetune repeated from
the same parameters and batches gives the same bits, which BCD's engines
need to select the same blocks.  TF32 stays off
(``repro_torch.use_full_float32``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch

import repro_torch
from . import optimizer as opt_lib


@contextlib.contextmanager
def deterministic(on: bool = True):
    """For the block's duration: cuDNN's deterministic algorithms and no
    autotuning (``cudnn.deterministic``, ``cudnn.benchmark``); the flags
    are put back afterwards.  Sets ``CUBLAS_WORKSPACE_CONFIG`` (if unset)
    for cuBLAS handles created from then on.  ``on=False`` changes
    nothing."""
    if not on:
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def cross_entropy(logits, labels, valid=None):
    """Mean CE over valid positions.  logits (..., V) any dtype; labels int.

    The max is taken out of the log-sum-exp (and out of the gradient), and
    the gold logit is picked with a one-hot reduce, as the reference does.
    """
    lf = logits.to(torch.float32)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    iota = torch.arange(lf.shape[-1], device=lf.device)
    onehot = (iota == labels[..., None]).to(lf.dtype)
    gold = torch.sum(lf * onehot, dim=-1)
    nll = lse - gold
    if valid is None:
        return torch.mean(nll)
    v = valid.to(torch.float32)
    return torch.sum(nll * v) / torch.clamp_min(torch.sum(v), 1.0)


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def loss_and_grads(fn: Callable, params, *args):
    """``jax.value_and_grad`` for a tree: ``fn(params, *args)`` returns the
    loss, or a tuple whose first element is the loss.  Returns ``(out,
    grads)``: fn's result detached, and the gradient tree of params, with
    zeros for a leaf the loss does not reach (as JAX gives)."""
    leaves = opt_lib.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        out = fn(opt_lib.tree_unflatten(params, live), *args)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return _detach(out), opt_lib.tree_unflatten(params, grads)


def make_cnn_train_step(model, opt, *, deterministic_algorithms=True):
    """Single-host CNN train step (the paper's reproduction scale).

    Returns ``(step, loss_fn)``: ``step(params, opt_state, masks, batch) ->
    (params, opt_state, loss, acc)`` and ``loss_fn(params, masks, batch,
    soft=False) -> (loss, acc[%])``, where masks is a mask tree of tensors
    and batch ``{"images", "labels"}`` tensors on the parameters' device.
    ``deterministic_algorithms=False`` leaves cuDNN's settings as they are
    (to measure what determinism costs)."""
    repro_torch.use_full_float32()

    def loss_fn(params, masks, batch, soft=False):
        logits = model.forward(params, masks, batch["images"], soft=soft)
        loss = cross_entropy(logits, batch["labels"])
        acc = torch.mean((logits.argmax(-1) == batch["labels"])
                         .to(torch.float32)) * 100.0
        return loss, acc

    def step(params, opt_state, masks, batch):
        with deterministic(deterministic_algorithms):
            (loss, acc), grads = loss_and_grads(loss_fn, params, masks,
                                                batch)
            updates, opt_state = opt.update(grads, opt_state, params)
            return (opt_lib.apply_updates(params, updates), opt_state, loss,
                    acc)

    return step, loss_fn


def make_eval_acc(forward: Callable, eval_batch: Dict):
    """``(params, masks) -> accuracy[%]`` (a 0-d tensor on the device) for
    ``forward(params, masks) -> logits``; masks are inputs, so candidate
    evaluation never rebuilds anything."""
    labels = eval_batch["labels"]

    def acc(params, masks):
        with torch.no_grad():
            logits = forward(params, masks)
            return torch.mean((logits.argmax(-1) == labels)
                              .to(torch.float32)) * 100.0
    return acc
