"""End-to-end LM training on the PyTorch port: data -> train loop ->
checkpoints -> fault-tolerant supervisor -> BCD linearization of the
trained model.

    PYTHONPATH=src python examples/torch_train_lm.py              # ~1M params
    PYTHONPATH=src python examples/torch_train_lm.py --dim 768 --layers 12 \
        --steps 300                                            # ~100M params

``examples/train_lm.py`` on ``repro_torch``, with its flags and defaults,
plus ``--device`` (the card unless asked for the CPU).  Demonstrates: the
Markov-token pipeline, AdamW + cosine, remat, checkpoint/restart with an
injected failure, the straggler watchdog, and a final BCD pass that removes
half of the FFN nonlinearities, its candidates evaluated through the
batched engine (stacked masks through the gate kernel's candidate axis).
"""
import argparse
import dataclasses
import shutil

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import bcd, engine, linearize, masks as M
from repro_torch.data import MarkovTokens
from repro_torch.models.lm import LM, token_accuracy
from repro_torch.training import ft
from repro_torch.training import optimizer as opt_lib, train as train_lib


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1p6b")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_lm_ckpt")
    ap.add_argument("--inject-failure", type=int, default=25,
                    help="simulate a node failure at this step (-1 = off)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the example; ``device`` overrides ``--device``.  Returns a dict
    of what it printed: ``params``, ``losses``, ``restarts``,
    ``flagged_steps``, ``kept``, ``total``, ``token_acc`` and the BCD
    ``result``."""
    args = parse_args(argv)
    device = device or args.device

    cfg = get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.dim,
        n_heads=max(4, args.dim // 32), n_kv_heads=max(2, args.dim // 64),
        head_dim=32, d_ff=args.dim * 3, vocab=args.vocab, dtype="float32")
    model = LM(cfg)

    mt = MarkovTokens(cfg.vocab, seed=0)
    opt = opt_lib.adamw(lr=3e-3, grad_clip=1.0,
                        schedule=opt_lib.cosine(3e-3, args.steps))
    train_step = train_lib.make_train_step(
        model, opt, train_lib.TrainStepCfg(remat=True, dp_axes=()))
    masks = M.as_device(linearize.init_masks(model.mask_sites()), device)

    losses, info = [], {}

    def init_state():
        gen = torch.Generator(device=device).manual_seed(1)
        state = train_lib.make_state(model, opt, gen, device)
        if not info:
            info["params"] = sum(t.numel() for t in
                                 opt_lib.tree_leaves(state["params"]))
            print(f"arch={cfg.name} params={info['params'] / 1e6:.1f}M")
        return state

    def step_fn(state, step):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in mt.batch(args.batch, args.seq, step).items()}
        state, metrics = train_step(state, b, masks)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:4d} loss {losses[-1]:.3f}")
        return state

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    injector = ft.FailureInjector(
        fail_at_steps=(args.inject_failure,) if args.inject_failure >= 0
        else ())
    watchdog = ft.StragglerWatchdog()
    out = ft.run_supervised(init_state, step_fn, n_steps=args.steps,
                            ckpt_dir=args.ckpt_dir, ckpt_every=10,
                            injector=injector, watchdog=watchdog,
                            device=device)
    state = out["state"]
    print(f"done: restarts={out['restarts']} "
          f"flagged_straggler_steps={out['flagged_steps']}")
    print(f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}")

    # ---- linearize the trained model with BCD ------------------------
    params = state["params"]
    eval_b = {k: torch.from_numpy(v).to(device)
              for k, v in mt.batch(16, args.seq, 10**6).items()}

    def token_acc_fn(m, ties=True, differ=None):
        with torch.no_grad():
            logits = model.forward(params, m, eval_b["tokens"], ties=ties,
                                   differ=differ)
            return linearize.per_candidate(
                token_accuracy(logits, eval_b["labels"]), m, differ)

    def token_acc(m):
        return float(token_acc_fn(M.as_device(m, device),
                                  ties=linearize.has_share_ties(m)))

    masks_h = linearize.init_masks(model.mask_sites())
    total = M.count(masks_h)
    # Candidate trials go through the batched engine: one forward per chunk
    # of stacked candidate mask trees (masks are inputs: nothing is rebuilt
    # across candidates).
    res = bcd.run_bcd(
        masks_h,
        bcd.BCDConfig(b_target=total // 2, drc=max(1, total // 10), rt=4,
                      adt=0.5, finetune_every_step=False, chunk_size=4),
        token_acc,
        evaluator=engine.BatchedEvaluator(token_acc_fn, pad_to=4,
                                          device=device),
        verbose=True)
    kept = M.count(res.masks)
    acc = token_acc(res.masks)
    print(f"BCD: kept {kept}/{total} FFN nonlinearities; "
          f"token acc {acc:.1f}%")
    return {"params": info["params"], "losses": losses,
            "restarts": out["restarts"],
            "flagged_steps": out["flagged_steps"], "kept": kept,
            "total": total, "token_acc": acc, "result": res}


if __name__ == "__main__":
    main()
