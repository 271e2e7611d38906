"""Train steps: the LM step with its loss, remat and gradient compression,
the CNN step, and an accuracy closure for BCD.

Counterpart of ``repro/training/train.py``: ``cross_entropy``,
``quantize_grads_int8``, ``TrainStepCfg``, ``make_state``,
``make_train_step`` (the LM), ``make_cnn_train_step`` and
``make_eval_acc``; and over a ``("data", "model")`` mesh ``state_specs``
and ``jit_train_step``, the sharded step: ZeRO-3 weights over ``"data"``
(gathered as each block runs, gradients reduce-scattered), data-parallel
gradients summed over ``"data"``, tensor parallelism over ``"model"``
(``models.lm.LM`` on a mesh), the loss over the vocabulary split over
``"model"``, and the clip's norm and the int8 compression over whole
leaves.

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


def _quantize_int8(g, amax=None, numel=None):
    """``amax``, ``numel``: the whole leaf's largest magnitude and size,
    where ``g`` is a shard of it."""
    if g.dim() == 0 or (g.numel() if numel is None else numel) < 1024:
        return g
    # divide by tensors: a CUDA division by a Python number is a product
    # with its reciprocal, which rounds twice
    c127 = torch.full((), 127.0, dtype=g.dtype, device=g.device)
    scale = (g.abs().max() if amax is None else amax) / c127 + 1e-12
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
    length).  ``fsdp``: under :func:`jit_train_step`, the ZeRO-3 weight
    sharding over ``"data"`` (``False``: data-parallel weights, whole on
    every data rank).  ``dp_axes``, ``model_axis`` and ``seq_shard_acts``
    name the reference's mesh axes and its sequence-sharding lever; they
    are accepted and change nothing (the batch splits over ``"data"``, the
    vocabulary over ``"model"``)."""

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


def state_specs(model, opt: opt_lib.Optimizer, data: int, model_ax: int,
                fsdp: bool = True):
    """Placement tree of the train state, the reference's: the parameters
    by ``models.lm.param_specs``, the moments as the parameters (a
    moment-less SGD ``nu`` as ``Spec()``), the counters ``Spec()``."""
    from repro_torch.core import spmd
    from repro_torch.models import lm as lm_lib
    pshapes = model.param_shapes()
    pspec = lm_lib.param_specs(pshapes, data, model_ax, fsdp)
    same = opt.init(pshapes).nu is not None
    return {"params": pspec,
            "opt": opt_lib.OptState(spmd.Spec(), pspec,
                                    pspec if same else spmd.Spec()),
            "step": spmd.Spec()}


def held_state_specs(model, opt: opt_lib.Optimizer, data: int,
                     model_ax: int, fsdp: bool = True):
    """The train state's layout as the port holds it: :func:`state_specs`
    with ``models.lm.held_param_specs`` for the parameters and moments."""
    from repro_torch.models import lm as lm_lib
    sp = state_specs(model, opt, data, model_ax, fsdp)
    held = lm_lib.held_param_specs(sp["params"], model.cfg, model_ax)
    o = sp["opt"]
    return {"params": held,
            "opt": opt_lib.OptState(o.step, held,
                                    held if o.nu is sp["params"] else o.nu),
            "step": sp["step"]}


def _mesh_sizes(mesh) -> Tuple[int, int]:
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.axis(mesh, "data").size, mesh_lib.axis(mesh, "model").size


def shard_state(state, model, opt: opt_lib.Optimizer, mesh,
                fsdp: bool = True):
    """A whole train state (:func:`make_state`) cut to this rank's held
    shards (:func:`held_state_specs`)."""
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.shard_tree(
        state, held_state_specs(model, opt, *_mesh_sizes(mesh), fsdp), mesh)


def _spec_leaves(specs) -> list:
    """The ``spmd.Spec`` leaves of a placement tree in
    ``optimizer.tree_leaves`` order (dict keys sorted)."""
    from repro_torch.core import spmd
    if isinstance(specs, spmd.Spec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [x for v in specs for x in _spec_leaves(v)]


def _per_leaf_over_axes(values, specs, axes, reduce):
    """``values`` (one per leaf, a 1-D tensor) reduced over each mesh axis
    of ``axes`` for the leaves split over it (one collective an axis)."""
    for ax in axes:
        if ax.size == 1:
            continue
        sel = torch.tensor([ax.name in s.axes() for s in specs],
                           device=values.device)
        if bool(sel.any()):
            values = torch.where(sel, reduce(torch.where(sel, values, 0),
                                             ax), values)
    return values


def _sumsq(grads: list, specs: list, axes) -> torch.Tensor:
    """Σ g² over whole leaves from their shards: each leaf's local sum is
    summed over the axes it is split on, so a leaf held whole on an axis
    counts once; then the leaves in order (a 0-d float32 tensor)."""
    from repro_torch.core import spmd
    local = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                         for g in grads])
    local = _per_leaf_over_axes(local, specs, axes, spmd.all_reduce_sum)
    return sum(local.unbind())


def _sum_over_data(grads: list, specs: list, axis) -> list:
    """Data-parallel gradients: every leaf not split over ``"data"``
    summed over it (one ``all_reduce`` a dtype, the leaves packed)."""
    from repro_torch.core import spmd
    if axis.size == 1:
        return grads
    grads = list(grads)
    todo = [i for i, s in enumerate(specs) if "data" not in s.axes()]
    for dt in sorted({grads[i].dtype for i in todo}, key=str):
        idx = [i for i in todo if grads[i].dtype == dt]
        flat = spmd.all_reduce_sum(
            torch.cat([grads[i].reshape(-1) for i in idx]), axis)
        at = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[at:at + n].view_as(grads[i])
            at += n
    return grads


def jit_train_step(model, opt: opt_lib.Optimizer, mesh,
                   cfg: TrainStepCfg = TrainStepCfg()):
    """The sharded train step over ``mesh`` (a ``("data", "model")``
    ``DeviceMesh``): :func:`make_train_step` of the model placed on the
    mesh (``models.lm.LM(cfg, mesh)``: tensor parallelism over
    ``"model"``), with ``cfg.fsdp``'s ZeRO-3 weights gathered over
    ``"data"`` as each block runs (and again in a remat backward), their
    gradients reduce-scattered.  ``state`` is the rank's shards in
    :func:`held_state_specs` (:func:`shard_state`)."""
    from repro_torch.models.lm import LM
    tpm = LM(model.cfg, mesh)
    data, model_ax = _mesh_sizes(mesh)
    if cfg.fsdp and data > 1:
        tpm.fsdp_specs = held_state_specs(tpm, opt, data, model_ax,
                                          True)["params"]
    return make_train_step(tpm, opt, cfg)


def _chunk_nll(h, labels, embed_t, axis=None):
    """Σ over a chunk's positions of the negative log-likelihood, the
    reference's chunk body: logits, log-sum-exp with the max taken out (of
    the gradient too), the gold logit by a one-hot reduce.  ``axis``: the
    vocabulary is split over it (``embed_t`` holds the rank's block of
    columns); the max, the sum of exponentials and the gold logit are
    reduced over it, as the reference's sharded-vocab-safe loss is."""
    from repro_torch.core import spmd
    return _nll_sum((spmd.enter(h, axis) @ embed_t.to(h.dtype))
                    .to(torch.float32), labels, axis)


def _nll_sum(lf, labels, axis=None):
    from repro_torch.core import spmd
    m = spmd.all_reduce_max(lf.max(dim=-1, keepdim=True).values.detach(),
                            axis)
    lse = torch.log(spmd.all_reduce_sum(torch.sum(torch.exp(lf - m),
                                                  dim=-1), axis)) + m[..., 0]
    iota = torch.arange(lf.shape[-1], device=lf.device)
    if axis is not None:
        iota = iota + axis.index * lf.shape[-1]
    gold = spmd.all_reduce_sum(
        torch.sum(lf * (iota == labels[..., None]).to(lf.dtype), dim=-1),
        axis)
    return torch.sum(lse - gold)


def make_loss_fn(model, cfg: TrainStepCfg = TrainStepCfg()):
    """The LM step's loss, ``loss_fn(params, masks, batch) -> loss`` (a
    0-d float32 tensor): mean cross-entropy over the text positions of
    ``batch = {"tokens", "labels"[, "prefix_embeds"]}`` (tensors on the
    parameters' device), under ``cfg.remat`` and ``cfg.loss_chunk``.

    A model on a mesh: ``batch`` is the rank's rows of the global batch,
    the loss the sum of their terms over the global count (the data ranks'
    losses add up to the mean), the vocabulary reduced over ``"model"``
    where it is split."""
    from torch.utils.checkpoint import checkpoint
    ranks = model.data_axis.size

    def loss_fn(params, masks, batch):
        tokens = batch["tokens"]
        pe = batch.get("prefix_embeds")
        S_text = tokens.shape[1]
        L = cfg.loss_chunk
        axis = model._tp if model._vocab_split(params["embed"]) else None
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
                    batch["labels"][:, c * L:(c + 1) * L], embed_t, axis,
                    use_reentrant=False, preserve_rng_state=False)
            return total / (hidden.shape[0] * ranks * S_text)
        logits = model.forward(params, masks, tokens, prefix_embeds=pe,
                               remat=cfg.remat)
        if pe is not None:
            logits = logits[:, pe.shape[1]:]   # loss on text positions only
        return _nll_sum(logits.to(torch.float32), batch["labels"],
                        axis) / (logits.shape[0] * ranks * S_text)

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
    takes it.  The forward runs unfused, under :func:`deterministic`.

    A model on a mesh (:func:`jit_train_step`) runs the same step on every
    rank: ``state`` is the rank's shards (:func:`held_state_specs`) and
    ``batch`` the whole global batch, of which the rank takes its rows of
    ``"data"``; the gradients of leaves not split over ``"data"`` are
    summed over it; ``compress_grads`` and the clip's norm go by whole
    leaves (their largest magnitude, size and sum of squares).  ``loss``
    and ``grad_norm`` are the same on every rank.  Every collective is the
    identity on an axis of one rank, so with no mesh this is the one-device
    step."""
    repro_torch.use_full_float32()
    from repro_torch.core import spmd
    dax, axes = model.data_axis, (model.data_axis, model.model_axis)
    held = held_state_specs(model, opt, dax.size, model.model_axis.size,
                            cfg.fsdp)
    specs = _spec_leaves(held["params"])
    numels = [t.numel() for t in opt_lib.tree_leaves(model.param_shapes())]
    loss_fn = make_loss_fn(model, cfg)

    def sumsq(gs):
        return _sumsq(gs, specs, axes)

    def train_step(state, batch, masks):
        lo, hi = dax.span(batch["tokens"].shape[0])
        batch = {k: v[lo:hi] for k, v in batch.items()}
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
            grads = _sum_over_data(opt_lib.tree_leaves(grads), specs, dax)
            if cfg.compress_grads:
                amax = _per_leaf_over_axes(
                    torch.stack([g.abs().max().to(torch.float32)
                                 for g in grads]),
                    specs, axes, spmd.all_reduce_max)
                grads = [_quantize_int8(g, a.to(g.dtype), n)
                         for g, a, n in zip(grads, amax.unbind(), numels)]
            gnorm = torch.sqrt(sumsq(grads))
            leaves, _ = opt_lib.step_leaves(
                opt, grads, opt_lib.OptState(
                    k, opt_lib.tree_leaves(mu),
                    None if nu is None else opt_lib.tree_leaves(nu)),
                leaves, sumsq=sumsq)
            loss = spmd.all_reduce_sum(loss, dax)
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
