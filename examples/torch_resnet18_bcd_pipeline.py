"""The paper's pipeline on ResNet18 in the PyTorch/CUDA port: train ->
SNL(B_ref) -> BCD(B_target) vs SNL(B_target) head-to-head (Fig. 1 /
Table 3 protocol, synthetic CIFAR), or the resumable budget sweep.

    PYTHONPATH=src python examples/torch_resnet18_bcd_pipeline.py \
        [--full] [--image-size 16] [--ref-frac 0.6] [--target-frac 0.4] \
        [--engine sequential|batched|sharded|pipelined|suffix] \
        [--chunk-size 8] \
        [--prefetch 2|auto] \
        [--moves remove,add_back,swap,stage_drop,share] \
        [--proposal uniform|sensitivity] [--device cuda|cpu]

``examples/resnet18_bcd_pipeline.py`` on the port (``repro_torch``), which
imports neither ``jax`` nor the JAX package.  The head-to-head mode:

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
card; ``--device cpu`` runs the plain PyTorch versions of the kernels.
--prefetch is the number of chunks the pipelined and suffix engines stage
ahead, or ``auto`` to pick it from measured rates (the pick lands in the
sweep artifact's notes).

Sweep mode (the paper's accuracy-vs-budget curve, Fig. 4 protocol):

    PYTHONPATH=src python examples/torch_resnet18_bcd_pipeline.py \
        --sweep 0.55,0.4 --out-dir runs/r18 [--engine suffix] [--overlap]

descends the budget schedule (fractions of all ReLUs) from the SNL warm
start, finetuning 12 steps after every accepted block and checkpointing
after each (``launch.sweep.run_sweep`` / ``core.runner.BCDRunner``).  Kill
it at any point — SIGKILL included — and rerunning the same command
resumes where it stopped, bit-identically; the warm start persisted under
<out-dir>/init is reused, so a resume skips training.  The curve lands in
<out-dir>/SWEEP_<model>.json.  BCD removes (B_ref - B_last) // 10 ReLUs
an outer step (at least 1): ten steps over the schedule.  --overlap runs each stage's reporting tail (finetune + test scoring) on a
worker thread while the next stage descends; masks and step logs stay
bit-identical to a serial sweep.

Multi-host: launch one process per rank with REPRO_COORD_RANK /
REPRO_COORD_WORLD / REPRO_COORD_DIR (shared path) / REPRO_COORD_SESSION
exported (``launch.coordinator.from_env``); rank 0 owns every checkpoint
and artifact, other ranks follow its lineage and verify they resumed the
same manifest fingerprint.  Unset, the run is plain single-process.

Candidate-parallel (``--engine sharded``): launch one process per rank
with ``python -m torch.distributed.run --nproc-per-node N
examples/torch_resnet18_bcd_pipeline.py --engine sharded ...``.  Every rank
runs the same descent and evaluates its share of each chunk
(``core.engine.ShardedEvaluator`` over ``launch.mesh.make_candidate_mesh``);
rank 0 alone prints and writes files (the coordinator's variables are
exported from the process group), and each rank's parameters are rank 0's
after every finetune.  One process without the launcher is a world of 1.
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
from repro_torch.core import runner  # noqa: E402
from repro_torch.launch import coordinator as coord_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sweep as sweep_lib  # noqa: E402
from repro_torch.models.resnet import CNN, CNNConfig  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import train as train_lib  # noqa: E402

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--ref-frac", type=float, default=0.6)
    ap.add_argument("--target-frac", type=float, default=0.4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--engine", default="batched",
                    choices=["sequential", "batched", "sharded",
                             "pipelined", "suffix"])
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--moves", default="remove",
                    help="comma-separated move kinds the descent samples "
                         f"from (subset of {','.join(M.MOVE_KINDS)})")
    ap.add_argument("--proposal", default="uniform",
                    choices=list(M.PROPOSALS))
    ap.add_argument("--prefetch", default="2",
                    help="chunks kept staged ahead (pipelined/suffix "
                         "engines), or 'auto' to pick from measured rates")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated descending budget fractions "
                         "(e.g. '0.55,0.4'): run the multi-budget sweep "
                         "instead of the single head-to-head")
    ap.add_argument("--out-dir", default=None,
                    help="sweep output/checkpoint directory (required with "
                         "--sweep)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap each sweep stage's reporting tail "
                         "(finetune + test scoring) with the next stage's "
                         "BCD descent; masks stay bit-identical to serial")
    args = ap.parse_args(argv)
    if args.sweep is None and args.overlap:
        ap.error("--overlap only applies to --sweep mode")
    args.moves = tuple(k.strip() for k in args.moves.split(","))
    for kind in args.moves:
        if kind not in M.MOVE_KINDS:
            ap.error(f"--moves: unknown kind {kind!r} (expected a subset "
                     f"of {','.join(M.MOVE_KINDS)})")
    if args.prefetch != "auto":
        try:
            args.prefetch = int(args.prefetch)
        except ValueError:
            ap.error(f"--prefetch must be an integer or 'auto', got "
                     f"{args.prefetch!r}")
    elif args.engine not in ("pipelined", "suffix"):
        ap.error("--prefetch auto requires --engine pipelined or suffix")
    if args.sweep is not None:
        if args.out_dir is None:
            ap.error("--sweep requires --out-dir")
        args.sweep = [float(f) for f in args.sweep.split(",")]
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


SNL_CFG = dict(lam0=5e-4, kappa=1.5, epochs=6, steps_per_epoch=5, lr=3e-2,
               finetune_steps=15)


def make_bcd_evaluator(args, model, eval_b, holder, chunk_size, rt):
    """The candidate engine (``launch.sweep.make_bcd_evaluator``); returns
    (evaluator, eval_acc, set_ctx).  Share-tied coordinates run outside
    the fused kernels, so the gate stays un-fused when the move set can
    produce ties."""
    return sweep_lib.make_bcd_evaluator(
        args.engine, model, eval_b, holder, chunk_size=chunk_size, rt=rt,
        prefetch=args.prefetch, fused_kernels="share" not in args.moves,
        device=args.device)


def sweep_drc(b_ref, budgets):
    """ReLUs a BCD outer step removes in sweep mode: ten steps over the
    whole schedule, at least one."""
    return max(1, (b_ref - budgets[-1]) // 10)


def run_sweep_mode(args):
    """The budget sweep: warm start (persisted under <out-dir>/init, reused
    on a resume), then ``run_sweep`` over the schedule.  Returns the
    artifact payload."""
    model, data = build_model_data(args)
    dev = args.device
    opt, step, batches, sloss, test_acc = make_closures(model, data, dev)
    masks0 = linearize.init_masks(model.mask_sites())
    total = M.count(masks0)
    b_ref = int(total * args.ref_frac)
    budgets = [int(total * f) for f in args.sweep]
    drc = sweep_drc(b_ref, budgets)
    print(f"total ReLUs {total}; B_ref={b_ref}; schedule={budgets}; "
          f"drc={drc}; device={dev}")

    sweep_cfg = sweep_lib.SweepConfig(
        budgets=budgets, out_dir=args.out_dir, name=model.cfg.name,
        overlap=args.overlap, verbose=True)
    coordinator = coord_lib.from_env(
        default_root=os.path.join(args.out_dir, "coord"))
    if runner.stage_init_exists(sweep_lib.init_dir(sweep_cfg)):
        # resume: params/masks come from the persisted warm start — the
        # untrained init only provides restore templates
        print(f"== reusing persisted warm start under "
              f"{sweep_lib.init_dir(sweep_cfg)} (skipping train + SNL)")
        init = {"kind": "snl", "masks": masks0,
                "params": model.init(torch.Generator().manual_seed(0), dev)}
    else:
        print("== train + SNL to B_ref (the sweep's warm start)")
        params = train_base(model, step, opt, batches, masks0, dev)
        alphas = {k: np.ones(v.shape, np.float32) for k, v in masks0.items()}
        init = run_snl(params, alphas, sloss, batches,
                       SNLConfig(b_target=b_ref, **SNL_CFG), verbose=True,
                       device=dev).stage_init()

    holder = {"params": mesh_lib.broadcast_tree(init["params"])}
    eval_b = data.train_eval_set(128)
    evaluator, eval_acc, set_ctx = make_bcd_evaluator(
        args, model, eval_b, holder, args.chunk_size, rt=6)

    def set_params(p):
        holder["params"] = mesh_lib.broadcast_tree(p)
        set_ctx(holder["params"])

    def ft(m):
        set_params(finetune(holder["params"], m, sloss, batches, steps=12,
                            lr=1e-2, device=dev))

    def make_bcd_cfg(budget):
        return bcd.BCDConfig(
            b_target=budget, drc=drc, rt=6, adt=0.3,
            chunk_size=args.chunk_size, moves=args.moves,
            proposal=args.proposal)

    # the reporting tail: pure in (params, masks), so with --overlap it can
    # score stage i on a worker thread while stage i+1's descent replaces
    # the live holder's params.  The finetuned params are reporting-only —
    # the descent continues from the descent-end state in both modes.
    def stage_ft(p, m):
        return finetune(p, m, sloss, batches, steps=12, lr=1e-2, device=dev)

    payload = sweep_lib.run_sweep(
        sweep_cfg, make_bcd_cfg, eval_acc, init=init, finetune=ft,
        evaluator=evaluator if args.engine != "sequential" else None,
        params_io=(lambda: holder["params"], set_params),
        stage_finetune=stage_ft,
        stage_eval=lambda m, p: test_acc(p, m),
        notes={"engine": args.engine, "prefetch": str(args.prefetch),
               "overlap": args.overlap, "moves": list(args.moves),
               "proposal": args.proposal},
        coordinator=coordinator, device=dev)

    report = getattr(evaluator, "auto_report", None)
    if report is not None and coordinator.is_writer:
        print(f"[auto-prefetch] depth={report['prefetch']} "
              f"producer={report['producer_s']:.4f}s "
              f"consumer={report['consumer_s']:.4f}s")
        sweep_lib.update_notes(sweep_cfg, {"auto_prefetch": report})

    print(f"\n=== sweep curve ({payload['artifact']}) ===")
    for s in payload["stages"]:
        acc = s.get("test_acc")
        print(f"B={s['budget']:6d}  steps={s['steps']:3d}  "
              f"acc={acc if acc is not None else float('nan'):.2f}%  "
              f"masks={s['mask_fingerprint'][:12]}")
        kinds = s.get("move_stats", {}).get("kinds", {})
        if kinds:
            rates = "  ".join(
                f"{k}={v['accepted']}/{v['proposed']}"
                for k, v in sorted(kinds.items()))
            print(f"         accepted/proposed: {rates}")
    return payload


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
    print("== SNL to B_ref (the paper's starting checkpoint)")
    res_ref = run_snl(params, alphas, sloss, batches,
                      SNLConfig(b_target=b_ref, **SNL_CFG), verbose=True,
                      device=dev)
    print("== SNL straight to B_target (baseline)")
    res_snl = run_snl(params, alphas, sloss, batches,
                      SNLConfig(b_target=b_target, **SNL_CFG), device=dev)
    acc_snl = test_acc(res_snl.params, res_snl.masks)

    print(f"== BCD from B_ref to B_target (ours, engine={args.engine})")
    eval_b = data.train_eval_set(128)
    holder = {"params": mesh_lib.broadcast_tree(res_ref.params)}
    bcd_cfg = bcd.BCDConfig(
        b_target=b_target, drc=max(1, (b_ref - b_target) // 5), rt=6,
        adt=0.3, chunk_size=args.chunk_size,
        moves=args.moves, proposal=args.proposal)
    evaluator, eval_acc, set_ctx = make_bcd_evaluator(
        args, model, eval_b, holder, bcd_cfg.chunk_size, bcd_cfg.rt)

    def ft(m):
        holder["params"] = mesh_lib.broadcast_tree(finetune(
            holder["params"], m, sloss, batches, steps=12, lr=1e-2,
            device=dev))
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
    if args.engine == "sharded":
        rank, _ = mesh_lib.join_sharded_run(args.device)
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
    if args.sweep is not None:
        run_sweep_mode(args)
    else:
        run_head_to_head(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
