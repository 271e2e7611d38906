"""Multi-budget BCD sweep on the LM model families in the PyTorch/CUDA
port (Fig. 4 protocol on recurrent/SSM and MoE stacks): train ->
SNL(B_ref) warm start -> budget schedule with finetuning between stages.

    PYTHONPATH=src python examples/torch_family_bcd_sweep.py \\
        --arch rwkv6_3b --sweep 0.6,0.45 --out-dir runs/rwkv6
    PYTHONPATH=src python examples/torch_family_bcd_sweep.py \\
        --arch deepseek_moe_16b --sweep 0.6,0.45 --out-dir runs/moe \\
        [--engine suffix] [--chunk-size 4] [--moves remove,swap,stage_drop]

``examples/family_bcd_sweep.py`` on the port (``repro_torch``), which
imports neither ``jax`` nor the JAX package.  Same driver stack as
``examples/torch_resnet18_bcd_pipeline.py`` (``launch.sweep`` on
``core.runner``: restartable, overlappable, multi-host-ready) but on
``models.lm`` at each family's ``reduced()`` config with Markov-token data,
on the card.  The training half differentiates the LM forward of every
family: the hard gates through ``kernels.ops.MaskedActFn`` and RWKV-6's
scan through ``kernels.ops.RWKV6ScanFn`` (its backward is the hand-written
``rwkv6_scan_bwd`` kernel).  What's family-specific is all below the
shared engine contract:

* recurrent families (rwkv6_3b, zamba2_2p7b's mamba blocks) cut their
  repeated block group at per-repeat virtual sites (``s0.rwkv@1``): the
  suffix engine's prefix returns the residual stream at repeat r, and the
  suffix resumes the remaining repeats from that checkpoint;
* MoE families (deepseek_moe_16b) route per-expert masked FFNs with
  deterministic capacity overflow, so stacked candidate evaluation gives
  sequential's routes and every engine selects the same blocks.

After the sweep, the mid-scan suffix path is exercised explicitly: a block
of candidates local to the DEEPEST per-repeat stack site is driven through
the suffix evaluator (asserting carry-checkpointed sited chunks actually
ran) and timed against the batched engine; the measured
``speedup_suffix_vs_batched`` lands as one line in BENCH_history.jsonl
(the row shape of ``benchmarks/bench_bcd_eval.py``), naming the card.

The reference's flags, without ``--compile-cache`` (the port has no JIT
to cache).  ``--engine sharded`` runs candidate-parallel under ``python -m
torch.distributed.run --nproc-per-node N``: every rank runs the same
descent and evaluates its share of each chunk, rank 0 alone prints and
writes files, and each rank's parameters are rank 0's after every
finetune; one process without the launcher is a world of 1.  A caller can
hand :func:`main` its own config, initial parameters and device (the
tests pass converted reference parameters on the CPU; ``chip_smoke.py``
the published widths on the card).
"""
import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import to_device  # noqa: E402
from repro_torch.core import bcd, engine, linearize  # noqa: E402
from repro_torch.core import masks as M, runner  # noqa: E402
from repro_torch.core.snl import SNLConfig, finetune, run_snl  # noqa: E402
from repro_torch.data import MarkovTokens  # noqa: E402
from repro_torch.launch import coordinator as coord_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sweep as sweep_lib  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.training import train as train_lib  # noqa: E402

# the warm start's and the stages' training, the reference's
TRAIN_LR = 3e-3
SNL_CFG = dict(lam0=5e-4, kappa=1.5, epochs=4, steps_per_epoch=5, lr=1e-2,
               finetune_steps=10)
FT_STEPS, FT_LR = 8, 1e-3
RT = 6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6_3b", choices=ARCH_IDS,
                    help="model family (reduced config): recurrent "
                         "(rwkv6_3b, zamba2_2p7b), MoE (deepseek_moe_16b, "
                         "mixtral_8x22b), or dense")
    ap.add_argument("--engine", default="suffix",
                    choices=["sequential", "batched", "sharded",
                             "pipelined", "suffix"])
    ap.add_argument("--chunk-size", type=int, default=4)
    ap.add_argument("--prefetch", default="2",
                    help="staged-ahead chunks (pipelined/suffix), or 'auto'")
    ap.add_argument("--moves", default="remove",
                    help="comma-separated move kinds (subset of "
                         f"{','.join(M.MOVE_KINDS)})")
    ap.add_argument("--proposal", default="uniform",
                    choices=list(M.PROPOSALS))
    ap.add_argument("--sweep", default="0.6,0.45",
                    help="descending budget fractions of the total "
                         "nonlinearity count")
    ap.add_argument("--ref-frac", type=float, default=0.75,
                    help="SNL warm-start budget fraction (B_ref)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=4)
    ap.add_argument("--bench-history", default=None,
                    help="append the post-sweep mid-scan suffix-vs-batched "
                         "timing here (default: <out-dir>/BENCH_history"
                         ".jsonl; 'none' to skip)")
    args = ap.parse_args(argv)
    args.moves = tuple(k.strip() for k in args.moves.split(","))
    for kind in args.moves:
        if kind not in M.MOVE_KINDS:
            ap.error(f"--moves: unknown kind {kind!r}")
    if args.prefetch != "auto":
        args.prefetch = int(args.prefetch)
    elif args.engine not in ("pipelined", "suffix"):
        ap.error("--prefetch auto requires --engine pipelined or suffix")
    args.sweep = [float(f) for f in args.sweep.split(",")]
    if args.bench_history is None:
        args.bench_history = os.path.join(args.out_dir,
                                          "BENCH_history.jsonl")
    return args


def make_closures(model, mt, args, device="cuda"):
    """Shared training/eval closures — deterministic in their inputs, so a
    resumed process rebuilds identical ones.  Batches follow the LM data
    contract: ``tokens`` (B, S) next-token-shifted against ``labels``."""
    def batches(i):
        return to_device(mt.batch(args.batch, args.seq, i), device)

    def sloss(p, a, batch, soft):
        logits = model.forward(p, a, batch["tokens"], soft=soft)
        return train_lib.cross_entropy(logits, batch["labels"]), 0.0

    # held-out scoring batch (a far-future step the train stream never hits)
    test_b = mt.batch(args.eval_batch, args.seq, 10**6)
    test_fn = model.make_param_eval_fn(test_b, device)

    def test_acc(m, p):
        with torch.no_grad():
            return float(test_fn(M.as_device(m, device), p))

    return batches, sloss, test_acc


def train_base(args, params, masks0, sloss, batches, device="cuda"):
    """The warm start's first half: AdamW under full masks."""
    return finetune(params, masks0, sloss, batches, steps=args.train_steps,
                    lr=TRAIN_LR, use_adam=True, device=device)


def snl_warm_start(params, masks0, sloss, batches, b_ref, device="cuda"):
    """The warm start's second half: SNL to B_ref, as a stage init."""
    alphas = {k: np.ones(v.shape, np.float32) for k, v in masks0.items()}
    return run_snl(params, alphas, sloss, batches,
                   SNLConfig(b_target=b_ref, **SNL_CFG), verbose=True,
                   device=device).stage_init()


def _time_sited_sweep(ev, masks, indices, chunk):
    """One full drive of ``indices`` through ``ev`` via the real trial-loop
    path (site-major plan for site-aware backends); returns (seconds,
    [sited chunk names])."""
    flat, layout = M._flatten(masks)
    sited_names = []
    if getattr(ev, "site_aware", False):
        ev.begin_step(masks)
        order, chunks = engine.plan_sited_chunks(ev, indices, layout, chunk)
        sited_names = [c[0] for c in chunks if c[0] is not None]
        gen = engine.materialize_sited(flat, layout, indices, order, chunks)
    else:
        gen = M.materialize_chunks(flat, layout, indices, chunk)
    t0 = time.perf_counter()
    for _accs in engine.evaluate_prefetched(ev, gen):
        pass
    return time.perf_counter() - t0, sited_names


def record_midscan_speedup(args, model, masks, params, eval_b,
                           device="cuda"):
    """Exercise the carry-checkpointed suffix path at a mid-scan stack site
    and record its measured speedup over the batched engine.

    Candidates are site-local to the DEEPEST per-repeat virtual site
    (``s<pos>.<kind>@r``, r >= 1): the suffix engine's prefix runs the
    stack up to repeat r and checkpoints the carry; each candidate then
    re-runs only repeats r.. and the tail.  Appends one
    bench-history-compatible line (per_site_depth row keyed "midscan") and
    returns the entry, or None when the family has no scanned stack."""
    mid = [s for s in model.site_order()
           if "@" in s and int(s.rsplit("@", 1)[1]) >= 1]
    if not mid:
        print(f"[midscan] {model.cfg.name}: no per-repeat stack sites — "
              "skipping the mid-scan timing")
        return None
    site = mid[-1]
    rt, reps = 16, 3
    chunk = min(args.chunk_size, rt)
    indices = M.sample_removal_indices_within(
        np.random.default_rng(7), masks, 8, rt, [site],
        repeat_sites=model.site_repeats())
    holder = {"params": params}
    suffix_ev, _, _ = sweep_lib.make_bcd_evaluator(
        "suffix", model, eval_b, holder, chunk_size=chunk, rt=rt,
        fused_kernels="share" not in args.moves, device=device)
    batched_ev, _, _ = sweep_lib.make_bcd_evaluator(
        "batched", model, eval_b, holder, chunk_size=chunk, rt=rt,
        fused_kernels="share" not in args.moves, device=device)

    # warmup (trie-populate), then check the plan really routed the chunk
    # through a carry-checkpointed sited evaluation
    _, sited = _time_sited_sweep(suffix_ev, masks, indices, chunk)
    _time_sited_sweep(batched_ev, masks, indices, chunk)
    ran_midscan = any("@" in s and int(s.rsplit("@", 1)[1]) >= 1
                      for s in sited)
    trie = suffix_ev.trie
    assert ran_midscan and (trie.misses + trie.extensions) > 0, (
        f"mid-scan candidates at {site} fell back to the full forward "
        f"(sited={sited}) — the carry-checkpoint suffix path did not run")

    # paired timing: alternate engines so host drift cancels in the ratio
    ratios, b_cps, s_cps = [], [], []
    for _ in range(reps):
        dt_s, _ = _time_sited_sweep(suffix_ev, masks, indices, chunk)
        dt_b, _ = _time_sited_sweep(batched_ev, masks, indices, chunk)
        ratios.append(dt_b / dt_s)
        s_cps.append(len(indices) / dt_s)
        b_cps.append(len(indices) / dt_b)
    ratio = round(float(np.median(ratios)), 2)
    frac = float(model.site_prefix_fractions()[site])
    print(f"[midscan] {model.cfg.name} {site}: suffix vs batched "
          f"{ratio:.2f}x (prefix_fraction={frac:.2f}, "
          f"trie misses={trie.misses} extensions={trie.extensions})")

    if args.bench_history == "none":
        return None
    try:
        git = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip() or None
    except Exception:
        git = None
    cuda = torch.device(device).type == "cuda"
    entry = {
        "utc": datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
        "git": git,
        "config": {"model": model.cfg.name, "dtype": model.cfg.dtype,
                   "chunk_size": chunk,
                   "eval_batch": args.eval_batch,
                   "n_devices": torch.cuda.device_count() if cuda else 1,
                   "backend": torch.cuda.get_device_name(0) if cuda
                   else "cpu",
                   "source": "torch_family_bcd_sweep"},
        "per_site_depth": {"midscan": {
            "site": site,
            "prefix_fraction": round(frac, 4),
            "mode": "suffix",
            "batched_cands_per_s": round(float(np.median(b_cps)), 2),
            "suffix_cands_per_s": round(float(np.median(s_cps)), 2),
            "speedup_suffix_vs_batched": ratio,
        }},
        "speedup_suffix_vs_batched_midscan": ratio,
    }
    os.makedirs(os.path.dirname(args.bench_history) or ".", exist_ok=True)
    with open(args.bench_history, "a") as f:
        json.dump(entry, f, separators=(",", ":"))
        f.write("\n")
    print(f"[midscan] recorded -> {args.bench_history}")
    return entry


def run(args, model, params, *, device="cuda"):
    """The sweep on ``model`` from initial ``params`` (a tree of tensors or
    numpy arrays): the warm start — trained here, or the one persisted
    under ``<out-dir>/init``, whose ``params`` are then only the restore
    template — then ``run_sweep`` down the schedule and the mid-scan
    timing.  Initial ``params`` on the host leave the card to the
    parameters being trained: a full-width model has no room for another
    copy beside them and their AdamW state.  Returns the artifact payload,
    with ``midscan`` (the bench-history entry, or None) added."""
    cfg = model.cfg
    mt = MarkovTokens(cfg.vocab, seed=0)
    batches, sloss, test_acc = make_closures(model, mt, args, device)
    masks0 = linearize.init_masks(model.mask_sites())
    total = M.count(masks0)
    b_ref = int(total * args.ref_frac)
    budgets = [int(total * f) for f in args.sweep]
    print(f"family={cfg.name} sites={list(model.mask_sites())} "
          f"repeats={model.site_repeats()}")
    print(f"total nonlinearities {total}; B_ref={b_ref}; "
          f"schedule={budgets}; device={device}")

    sweep_cfg = sweep_lib.SweepConfig(
        budgets=budgets, out_dir=args.out_dir, name=cfg.name,
        overlap=args.overlap, verbose=True)
    coordinator = coord_lib.from_env(
        default_root=os.path.join(args.out_dir, "coord"))
    if runner.stage_init_exists(sweep_lib.init_dir(sweep_cfg)):
        print(f"== reusing persisted warm start under "
              f"{sweep_lib.init_dir(sweep_cfg)} (skipping train + SNL)")
        # params are only the restore template here: the persisted warm
        # start is loaded onto the device, the template stays where it is
        init = {"kind": "snl", "masks": masks0, "params": params}
    else:
        print("== train + SNL to B_ref (the sweep's warm start)")
        trained = train_base(args, params, masks0, sloss, batches, device)
        init = snl_warm_start(trained, masks0, sloss, batches, b_ref,
                              device)
        del trained

    holder = {"params": mesh_lib.broadcast_tree(init["params"])}
    eval_b = {"tokens": mt.batch(args.eval_batch, args.seq,
                                 10**6 + 1)["tokens"]}
    evaluator, eval_acc, set_ctx = sweep_lib.make_bcd_evaluator(
        args.engine, model, eval_b, holder, chunk_size=args.chunk_size,
        rt=RT, prefetch=args.prefetch,
        fused_kernels="share" not in args.moves, device=device)

    def set_params(p):
        holder["params"] = mesh_lib.broadcast_tree(p)
        set_ctx(holder["params"])

    def ft(m):
        set_params(finetune(holder["params"], m, sloss, batches,
                            steps=FT_STEPS, lr=FT_LR, use_adam=True,
                            device=device))

    def make_bcd_cfg(budget):
        return bcd.BCDConfig(
            b_target=budget, drc=max(1, (b_ref - budgets[-1]) // 10), rt=RT,
            adt=0.3, chunk_size=args.chunk_size,
            moves=args.moves, proposal=args.proposal)

    def stage_ft(p, m):
        return finetune(p, m, sloss, batches, steps=FT_STEPS, lr=FT_LR,
                        use_adam=True, device=device)

    payload = sweep_lib.run_sweep(
        sweep_cfg, make_bcd_cfg, eval_acc, init=init, finetune=ft,
        evaluator=evaluator if args.engine != "sequential" else None,
        params_io=(lambda: holder["params"], set_params),
        stage_finetune=stage_ft,
        stage_eval=test_acc,
        notes={"arch": args.arch, "engine": args.engine,
               "prefetch": str(args.prefetch), "overlap": args.overlap,
               "moves": list(args.moves), "proposal": args.proposal},
        coordinator=coordinator, device=device)
    del init

    print(f"\n=== sweep curve ({payload['artifact']}) ===")
    for s in payload["stages"]:
        acc = s.get("test_acc")
        print(f"B={s['budget']:6d}  steps={s['steps']:3d}  "
              f"acc={acc if acc is not None else float('nan'):.2f}%  "
              f"masks={s['mask_fingerprint'][:12]}")

    payload["midscan"] = None
    if coordinator.is_writer:
        payload["midscan"] = record_midscan_speedup(
            args, model, payload["final_masks"], holder["params"], eval_b,
            device)
    return payload


def main(argv=None, *, cfg=None, params=None, device="cuda"):
    """The CLI: ``cfg`` defaults to the family's ``reduced()`` config and
    ``params`` to ``LM(cfg).init`` from seed 0 on ``device``."""
    args = parse_args(argv)
    if args.engine == "sharded":
        rank, _ = mesh_lib.join_sharded_run(device)
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
    cfg = cfg or get_config(args.arch).reduced()
    model = LM(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
    return run(args, model, params, device=device)


if __name__ == "__main__":
    main()
