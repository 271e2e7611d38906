"""The paper's pipeline on ResNet18 in the PyTorch/CUDA port: train ->
SNL(B_ref) -> BCD(B_target) vs SNL(B_target) head-to-head (Fig. 1 /
Table 3 protocol, synthetic CIFAR).

    PYTHONPATH=src python examples/torch_resnet18_bcd_pipeline.py \
        [--full] [--image-size 16] [--ref-frac 0.6] [--target-frac 0.4] \
        [--engine sequential|batched|pipelined|suffix] [--chunk-size 8] \
        [--moves remove,add_back,swap,stage_drop,share] \
        [--proposal uniform|sensitivity] [--device cuda|cpu]

The head-to-head mode of ``examples/resnet18_bcd_pipeline.py``, on the
port (``repro_torch``), which imports neither ``jax`` nor the JAX package:

  train_base   80 SGD steps at 5e-2 under full masks
  SNL          to B_ref (the paper's starting checkpoint), then straight to
               B_target (the baseline)
  BCD          from B_ref to B_target through the chosen candidate engine,
               finetuning 12 steps at 1e-2 (``snl.finetune``) after every
               accepted block
  results      test accuracy of both at B_target, and whether BCD's budget
               is exact

--full runs the real ResNet18 at 32x32 on CIFAR-10-shaped data; the default
is a reduced stage plan with the same code path.  --device defaults to the
card; ``--device cpu`` runs the plain PyTorch versions of the kernels.  The
sweep mode (``--sweep``, ``--out-dir``, resume) and the multi-host
coordinator (``REPRO_COORD_*``) of the JAX example are not ported yet: asked
for, this script says so and exits with status 2.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.convert import to_device  # noqa: E402
from repro_torch.core import bcd, linearize, masks as M  # noqa: E402
from repro_torch.core.snl import SNLConfig, finetune, run_snl  # noqa: E402
from repro_torch.data import ImageDatasetCfg, SyntheticImages  # noqa: E402
from repro_torch.launch import sweep as sweep_lib  # noqa: E402
from repro_torch.models.resnet import CNN, CNNConfig  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import train as train_lib  # noqa: E402

NOT_PORTED = ("the sweep mode (--sweep, --out-dir, resume) and the "
              "multi-host coordinator are not ported to repro_torch yet; "
              "run examples/resnet18_bcd_pipeline.py for them")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--ref-frac", type=float, default=0.6)
    ap.add_argument("--target-frac", type=float, default=0.4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--engine", default="batched",
                    choices=["sequential", "batched", "pipelined",
                             "suffix"])
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--moves", default="remove",
                    help="comma-separated move kinds the descent samples "
                         f"from (subset of {','.join(M.MOVE_KINDS)})")
    ap.add_argument("--proposal", default="uniform",
                    choices=list(M.PROPOSALS))
    ap.add_argument("--device", default="cuda")
    # not ported yet: accepted only to say so
    ap.add_argument("--sweep", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.moves = tuple(k.strip() for k in args.moves.split(","))
    for kind in args.moves:
        if kind not in M.MOVE_KINDS:
            ap.error(f"--moves: unknown kind {kind!r} (expected a subset "
                     f"of {','.join(M.MOVE_KINDS)})")
    return args


def build_model_data(args):
    if args.full:
        model = CNN(CNNConfig.resnet18(10, 32))
        data = SyntheticImages(ImageDatasetCfg.cifar10())
    else:
        model = CNN(CNNConfig("r18-mini", 4, args.image_size,
                              ((8, 2, 1), (16, 2, 2)), stem_channels=8))
        data = SyntheticImages(ImageDatasetCfg(
            n_classes=4, image_size=args.image_size, n_train=256, n_test=64))
    return model, data


def make_closures(model, data, device):
    """The shared training and evaluation closures."""
    opt = opt_lib.sgd(lr=5e-2, momentum=0.9)
    step, _ = train_lib.make_cnn_train_step(model, opt)
    batches_np = data.batches("train", 32)

    def batches(i):
        return to_device(batches_np(i), device)

    def sloss(p, a, batch, soft):
        logits = model.forward(p, a, batch["images"], soft=soft)
        return train_lib.cross_entropy(logits, batch["labels"]), 0.0

    test_b = to_device(data.eval_set(64), device)
    test_acc_fn = train_lib.make_eval_acc(
        lambda p, m: model.forward(p, m, test_b["images"]), test_b)

    def test_acc(p, m):
        return float(test_acc_fn(p, M.as_device(m, device)))

    return opt, step, batches, sloss, test_acc


def train_base(model, step, opt, batches, masks0, device):
    params = model.init(torch.Generator().manual_seed(0), device)
    ostate = opt.init(params)
    mdev = M.as_device(masks0, device)
    for i in range(80):
        params, ostate, _loss, _acc = step(params, ostate, mdev, batches(i))
    return params


def run_head_to_head(args):
    model, data = build_model_data(args)
    dev = args.device
    opt, step, batches, sloss, test_acc = make_closures(model, data, dev)
    masks0 = linearize.init_masks(model.mask_sites())
    total = M.count(masks0)
    b_ref = int(total * args.ref_frac)
    b_target = int(total * args.target_frac)
    print(f"total ReLUs {total}; B_ref={b_ref}; B_target={b_target}; "
          f"device={dev}")

    t0 = time.perf_counter()
    params = train_base(model, step, opt, batches, masks0, dev)
    print(f"== train_base: 80 steps in {time.perf_counter() - t0:.1f}s")

    alphas = {k: np.ones(v.shape, np.float32) for k, v in masks0.items()}
    snl_cfg = dict(lam0=5e-4, kappa=1.5, epochs=6, steps_per_epoch=5,
                   lr=3e-2, finetune_steps=15)
    print("== SNL to B_ref (the paper's starting checkpoint)")
    res_ref = run_snl(params, alphas, sloss, batches,
                      SNLConfig(b_target=b_ref, **snl_cfg), verbose=True,
                      device=dev)
    print("== SNL straight to B_target (baseline)")
    res_snl = run_snl(params, alphas, sloss, batches,
                      SNLConfig(b_target=b_target, **snl_cfg), device=dev)
    acc_snl = test_acc(res_snl.params, res_snl.masks)

    print(f"== BCD from B_ref to B_target (ours, engine={args.engine})")
    eval_b = data.train_eval_set(128)
    holder = {"params": res_ref.params}
    bcd_cfg = bcd.BCDConfig(
        b_target=b_target, drc=max(1, (b_ref - b_target) // 5), rt=6,
        adt=0.3, chunk_size=args.chunk_size,
        moves=args.moves, proposal=args.proposal)
    evaluator, eval_acc, set_ctx = sweep_lib.make_bcd_evaluator(
        args.engine, model, eval_b, holder, chunk_size=bcd_cfg.chunk_size,
        rt=bcd_cfg.rt, prefetch=2, fused_kernels="share" not in args.moves,
        device=dev)

    def ft(m):
        holder["params"] = finetune(holder["params"], m, sloss, batches,
                                    steps=12, lr=1e-2, device=dev)
        set_ctx(holder["params"])

    res_bcd = bcd.run_bcd(res_ref.masks, bcd_cfg, eval_acc, finetune=ft,
                          evaluator=evaluator, verbose=True)
    acc_bcd = test_acc(holder["params"], res_bcd.masks)

    print(f"\n=== results at B_target={b_target} ===")
    print(f"SNL : test acc {acc_snl:.2f}%")
    print(f"BCD : test acc {acc_bcd:.2f}%  (budget exact: "
          f"{M.relu_cost(res_bcd.masks) == b_target})")
    kinds = res_bcd.move_stats.get("kinds", {})
    if len(args.moves) > 1 and kinds:
        print("BCD accepted/proposed by kind: " + "  ".join(
            f"{k}={v['accepted']}/{v['proposed']}"
            for k, v in sorted(kinds.items())))
    return res_bcd


def main(argv=None) -> int:
    args = parse_args(argv)
    coord = [v for v in ("REPRO_COORD_RANK", "REPRO_COORD_WORLD",
                         "REPRO_COORD_DIR") if os.environ.get(v)]
    if args.sweep is not None or args.out_dir is not None or coord:
        print(f"torch_resnet18_bcd_pipeline: {NOT_PORTED}", file=sys.stderr)
        return 2
    run_head_to_head(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
