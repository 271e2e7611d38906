"""Functions that wire a model to a BCD candidate engine.

Counterpart of ``repro/launch/sweep.py``; only the family-agnostic evaluator
function is here so far (the multi-budget sweep loop comes with the runner
and checkpoints).
"""
from __future__ import annotations

import torch

from repro_torch.convert import to_device
from repro_torch.core import engine, linearize
from repro_torch.core import masks as M


def make_bcd_evaluator(engine_name: str, model, eval_b, holder, *,
                       chunk_size: int, rt: int, prefetch=2,
                       fused_kernels: bool = True, device="cuda"):
    """Build the BCD candidate engine for any model family.

    Model-agnostic: works for every model exposing the shared eval-closure
    contract (``make_param_eval_fn`` / ``make_suffix_eval_fns`` /
    ``make_eval_acc``).  Params are evaluator *context* because finetuning
    rewrites them between outer steps; ``holder`` is the live
    ``{"params": ...}`` box the caller mutates (its params are moved to
    ``device`` in place here, as is a copy of the eval batch).

    Returns ``(evaluator, eval_acc, set_ctx)``: call ``set_ctx(params)``
    after every finetune — engines differ in context shape (the suffix
    engine carries the eval batch alongside params), so callers never
    touch ``set_context`` directly.  ``fused_kernels=False`` keeps the
    activation gate un-fused on the suffix backend; pass
    ``fused_kernels="share" not in moves`` when the move set can produce
    share ties (chunks that carry ties run unfused in any case — see
    ``linearize._apply_share_ties``).  ``device`` defaults to the card.
    """
    eval_b = to_device(dict(eval_b), device)
    holder["params"] = to_device(holder["params"], device)
    eval_fn_p = model.make_param_eval_fn(eval_b, device)

    def eval_acc(m):
        ties = linearize.has_share_ties(m)            # host decision
        with torch.no_grad():
            return float(eval_fn_p(M.as_device(m, device), holder["params"],
                                   ties=ties))
    if engine_name == "sequential":
        return engine.make_evaluator("sequential", eval_acc=eval_acc), \
            eval_acc, lambda p: None
    # don't let ragged-chunk padding exceed RT
    pad = min(chunk_size, rt)
    if engine_name == "suffix":
        evaluator = engine.make_evaluator(
            "suffix", split=model.make_suffix_eval_fns(),
            context={"params": holder["params"], "batch": eval_b},
            pad_to=pad, prefetch=prefetch, fused_kernels=fused_kernels,
            device=device)
        return evaluator, eval_acc, lambda p: evaluator.set_context(
            {"params": p, "batch": eval_b})
    evaluator = engine.make_evaluator(
        engine_name, eval_fn=eval_fn_p, pad_to=pad,
        context=holder["params"], prefetch=prefetch, device=device)
    return evaluator, eval_acc, evaluator.set_context
