"""What one ``gloo`` all-reduce costs between ranks that share one card.

Sharded serving and training (``models.lm.LM`` on a mesh) reduce over a
mesh axis with ``core.spmd``'s functions, each one ``all_reduce`` of the
``gloo`` process group (``nccl`` refuses two ranks on one card).  For 1, 2
and 4 ranks, spawned on the first card, this times 20 reductions of
float32 tensors of 1,024, 400,000 and 4,000,000 entries: on the CUDA
tensor itself (``cuda``), and staged through a host copy (``host``); and
200 small products with a ``tanh`` alone, to see the card shared.  One
JSON line per rank count, milliseconds per call (rank 0's clock).

    python3 tools/torch_gloo_probe.py [--ranks 1,2,4]

Needs a CUDA device; ``--device cpu`` rehearses it.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES = (1024, 400_000, 4_000_000)
REPS = 20


def _rank(rank, world, store, device, out):
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    res = {}
    for n in SIZES:
        t = torch.ones(n, device=device)
        for mode in ("cuda", "host"):
            def once():
                if mode == "cuda":
                    dist.all_reduce(t)
                else:
                    h = t.cpu()
                    dist.all_reduce(h)
                    t.copy_(h)
            for _ in range(3):
                once()
            sync()
            t0 = time.perf_counter()
            for _ in range(REPS):
                once()
            sync()
            res[f"{mode}_{n}_ms"] = (time.perf_counter() - t0) / REPS * 1e3
    a = torch.randn(64, 2048, device=device)
    w = torch.randn(2048, 2048, device=device)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        a = torch.tanh(a @ w * 1e-3)
    sync()
    res["products_200_ms"] = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    for world in (int(x) for x in args.ranks.split(",")):
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "out.json")
            mp.spawn(_rank, args=(world, os.path.join(d, "store"),
                                  args.device, out), nprocs=world)
            with open(out) as f:
                print(json.dumps({"ranks": world, **json.load(f)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
