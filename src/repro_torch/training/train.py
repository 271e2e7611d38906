"""Train steps: the LM step with its loss, remat and gradient compression,
the CNN step, and an accuracy closure for BCD.

Counterpart of ``repro/training/train.py``: ``cross_entropy``,
``quantize_grads_int8``, ``TrainStepCfg``, ``make_state``,
``make_train_step`` (the LM), ``make_cnn_train_step`` and
``make_eval_acc``.  The sharded factories ``state_specs`` and
``jit_train_step`` need more than one device and raise (``ROADMAP.md``
Queue A11).

A step differentiates with ``torch.autograd.grad`` with respect to the
parameter leaves (:func:`loss_and_grads`).  The CNN step updates with
``training.optimizer`` and returns new trees.  The LM step updates leaf by
leaf **in place** (``optimizer.step_leaves``): it consumes the state it is
given, as the reference's jitted step donates it, so that a model whose
parameters, gradients and two moments fill the card trains on it.
BatchNorm uses batch statistics in training as in evaluation
(``models/resnet.py``).  The hard-mask gate is differentiable through
``kernels.ops.MaskedActFn`` (its backward is ``gate_bwd_kernel`` on the
card, in float32 or bfloat16); the forward runs unfused (``fused=False``),
as the fused kernels have no backward.  A bfloat16 model trains as the
reference's does: bfloat16 gradients and moments (``training.optimizer``),
the loss and the gradient norm in float32.

Training entry points run under :func:`deterministic` — cuDNN's
deterministic algorithms, no autotuning — so that a finetune repeated from
the same parameters and batches gives the same bits, which BCD's engines
need to select the same blocks.  TF32 stays off
(``repro_torch.use_full_float32``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Tuple

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


# -------------------------------------------------------------- LM path


def _quantize_int8(g):
    if g.dim() == 0 or g.numel() < 1024:
        return g
    # divide by tensors: a CUDA division by a Python number is a product
    # with its reciprocal, which rounds twice
    c127 = torch.full((), 127.0, dtype=g.dtype, device=g.device)
    scale = g.abs().max() / c127 + 1e-12
    return torch.round(g / scale).to(torch.int8).to(g.dtype) * scale


def quantize_grads_int8(grads):
    """Per-tensor symmetric int8 quantize → dequantize (gradient
    compression: the numbers an 8-bit gradient all-reduce would deliver).
    Rounds half to even, as ``jnp.round``; 0-d leaves and leaves of fewer
    than 1024 entries pass through.  A tree or a list of leaves."""
    return opt_lib.tree_map(_quantize_int8, grads)


@dataclasses.dataclass
class TrainStepCfg:
    """Train-step knobs.  ``remat``: each stack repeat recomputed in the
    backward (``LM.forward(remat=)``); ``compress_grads``:
    :func:`quantize_grads_int8` before the update; ``loss_chunk``: the
    loss over sequence chunks of this length, each chunk's logits
    recomputed in the backward, so live logits are ``(B, loss_chunk, V)``
    (0: the whole sequence; also used when it does not divide the text
    length).  ``dp_axes``, ``fsdp``, ``model_axis`` and ``seq_shard_acts``
    name the reference's mesh axes and sharding levers; they are accepted
    and change nothing on one device (a mesh is ``ROADMAP.md`` Queue
    A11)."""

    remat: bool = True
    compress_grads: bool = False
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = True
    model_axis: str = "model"
    loss_chunk: int = 0
    seq_shard_acts: bool = False


def _counter(n: int):
    """A train-state counter: a 0-d int32 on the host, the reference's
    dtype (so both packages write the same leaf file)."""
    return torch.tensor(n, dtype=torch.int32)


def make_state(model, opt: opt_lib.Optimizer, generator: torch.Generator,
               device="cuda"):
    """Fresh train state ``{"params", "opt": OptState(step, mu, nu),
    "step"}``: ``model.init(generator, device)``, the optimizer's moments,
    and both counters 0 (0-d int32 tensors on the host)."""
    params = model.init(generator, device)
    ostate = opt.init(params)
    return {"params": params,
            "opt": opt_lib.OptState(_counter(0), ostate.mu, ostate.nu),
            "step": _counter(0)}


def state_specs(*args, **kwargs):
    """The train state's sharding specs: needs a mesh of devices."""
    raise NotImplementedError(
        "state_specs: sharding the train state over a mesh is not ported "
        "(multi-device, ROADMAP.md Queue A11); make_train_step runs on one "
        "device")


def jit_train_step(*args, **kwargs):
    """The sharded, jitted train step: needs a mesh of devices."""
    raise NotImplementedError(
        "jit_train_step: the sharded train step is not ported "
        "(multi-device, ROADMAP.md Queue A11); use make_train_step on one "
        "device")


def _chunk_nll(h, labels, embed_t):
    """Σ over a chunk's positions of the negative log-likelihood, the
    reference's chunk body: logits, log-sum-exp with the max taken out (of
    the gradient too), the gold logit by a one-hot reduce."""
    lf = (h @ embed_t.to(h.dtype)).to(torch.float32)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    iota = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.sum(lf * (iota == labels[..., None]).to(lf.dtype), dim=-1)
    return torch.sum(lse - gold)


def make_loss_fn(model, cfg: TrainStepCfg = TrainStepCfg()):
    """The LM step's loss, ``loss_fn(params, masks, batch) -> loss`` (a
    0-d float32 tensor): mean cross-entropy over the text positions of
    ``batch = {"tokens", "labels"[, "prefix_embeds"]}`` (tensors on the
    parameters' device), under ``cfg.remat`` and ``cfg.loss_chunk``."""
    from torch.utils.checkpoint import checkpoint

    def loss_fn(params, masks, batch):
        tokens = batch["tokens"]
        pe = batch.get("prefix_embeds")
        S_text = tokens.shape[1]
        L = cfg.loss_chunk
        if L and S_text % L == 0:
            hidden = model.forward(params, masks, tokens, prefix_embeds=pe,
                                   remat=cfg.remat, return_hidden=True)
            if pe is not None:
                hidden = hidden[:, pe.shape[1]:]
            embed_t = params["embed"].T
            total = torch.zeros((), dtype=torch.float32,
                                device=hidden.device)
            for c in range(S_text // L):
                total = total + checkpoint(
                    _chunk_nll, hidden[:, c * L:(c + 1) * L],
                    batch["labels"][:, c * L:(c + 1) * L], embed_t,
                    use_reentrant=False, preserve_rng_state=False)
            return total / (hidden.shape[0] * S_text)
        logits = model.forward(params, masks, tokens, prefix_embeds=pe,
                               remat=cfg.remat)
        if pe is not None:
            logits = logits[:, pe.shape[1]:]   # loss on text positions only
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def make_train_step(model, opt: opt_lib.Optimizer,
                    cfg: TrainStepCfg = TrainStepCfg()):
    """Returns ``train_step(state, batch, masks) -> (state, {"loss",
    "grad_norm"})`` for a state from :func:`make_state` (or restored into
    its template) — a 0-d tensor each.

    The step consumes ``state``: its dict is emptied, its moments are
    updated in place and each parameter leaf is replaced as soon as its
    update is made (``optimizer.step_leaves``), so the peak is the
    parameters, their gradients, the moments and the forward's saved
    activations — the reference's ``donate_argnums=(0,)``.  ``grad_norm``
    is taken after compression and before the clip, as the reference
    takes it.  The forward runs unfused, under :func:`deterministic`."""
    repro_torch.use_full_float32()
    loss_fn = make_loss_fn(model, cfg)

    def train_step(state, batch, masks):
        tree, ostate = state["params"], state["opt"]
        leaves = opt_lib.tree_leaves(tree)
        like = opt_lib.tree_unflatten(tree, [0] * len(leaves))
        step, k = int(state["step"]), int(ostate.step)
        mu, nu = ostate.mu, ostate.nu
        state.clear()
        del tree, ostate
        with deterministic():
            loss, grads = loss_and_grads(
                loss_fn, opt_lib.tree_unflatten(like, leaves), masks, batch)
            grads = opt_lib.tree_leaves(grads)
            if cfg.compress_grads:
                grads = [_quantize_int8(g) for g in grads]
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for g in grads))
            leaves, _ = opt_lib.step_leaves(
                opt, grads, opt_lib.OptState(
                    k, opt_lib.tree_leaves(mu),
                    None if nu is None else opt_lib.tree_leaves(nu)),
                leaves)
        new = {"params": opt_lib.tree_unflatten(like, leaves),
               "opt": opt_lib.OptState(_counter(k + 1), mu, nu),
               "step": _counter(step + 1)}
        return new, {"loss": loss, "grad_norm": gnorm}

    return train_step


# ------------------------------------------------------------- CNN path


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
