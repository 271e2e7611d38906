"""Training launcher: supervised, checkpointed LM training, on one device
or over a ``("data", "model")`` mesh of ranks.

Counterpart of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1p6b \
        --reduced --steps 20 --mesh 1,1 --ckpt-dir /tmp/ck --device cpu

AdamW on a cosine schedule with a gradient clip of 1.0, remat, Markov
tokens, under ``training.ft.run_supervised`` (restart from the newest
valid checkpoint) with the straggler watchdog.  A rerun with more
``--steps`` and the same ``--ckpt-dir`` resumes from the newest
checkpoint.

``--mesh d,m`` other than ``1,1`` trains sharded (``training.train.
jit_train_step``: ZeRO-3 over ``"data"``, tensor parallelism over
``"model"``) on the first d·m ranks of the process group, which must hold
exactly d·m ranks (``python -m torch.distributed.run --nproc_per_node
d·m``, or a group the caller brought up); every rank runs this with the
same flags, rank 0 prints and writes the checkpoints.  ``--device``
defaults to the card.  A config trains in its own dtype: the
published configs in bfloat16 (bfloat16 parameters and AdamW moments, the
float32 leaves of the inits kept float32, the loss and the clip's norm in
float32, as the reference trains them), ``--reduced`` ones in float32.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import linearize, masks as M
from repro_torch.data import MarkovTokens, host_slice
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import LM
from repro_torch.training import ft
from repro_torch.training import optimizer as opt_lib, train as train_lib


def parse_args(argv=None):
    """The reference's flags and defaults, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1p6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1,1", help="data,model axis sizes")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_launch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat-group", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_config(args):
    """The run's config: ``--arch`` (``--reduced``) with ``--remat-group``,
    in the config's own dtype."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, remat_group=args.remat_group)


def make_mesh(args, device="cuda"):
    """``--mesh d,m`` as a mesh over the process group (None for ``1,1``).
    Raises where the group does not hold exactly d·m ranks."""
    d, m = (int(x) for x in args.mesh.split(","))
    if (d, m) == (1, 1):
        return None
    mesh = mesh_lib.make_host_mesh(d, m, device)
    world = mesh_lib.process_info()[1]
    if world != d * m:
        raise ValueError(f"--mesh {args.mesh} needs a world of {d * m} "
                         f"ranks, the process group holds {world}")
    return mesh


def run(args, cfg, device="cuda", injector=None) -> dict:
    """Train ``cfg`` for ``args.steps`` steps under the supervisor.
    Returns ``losses`` (one float a step run, a replayed step again),
    ``step_ms`` (each step's wall-clock, the loss read back) and
    ``result``, ``run_supervised``'s dict.  ``injector``: an optional
    ``ft.FailureInjector``.  With ``--mesh`` other than ``1,1`` every rank
    runs this; the state in ``result`` is the rank's shards."""
    model = LM(cfg)
    opt = opt_lib.adamw(lr=args.lr, grad_clip=1.0,
                        schedule=opt_lib.cosine(args.lr, args.steps))
    tcfg = train_lib.TrainStepCfg(remat=True, dp_axes=("data",),
                                  compress_grads=args.compress_grads)
    mesh = make_mesh(args, device)
    step = train_lib.jit_train_step(model, opt, mesh, tcfg)
    shardings = None
    if mesh is not None:
        d, m = (int(x) for x in args.mesh.split(","))
        shardings = mesh_lib.Shardings(mesh, train_lib.held_state_specs(
            model, opt, d, m, tcfg.fsdp))
    mt = MarkovTokens(cfg.vocab, seed=0)
    masks = M.as_device(linearize.init_masks(model.mask_sites()), device)
    sl = host_slice(args.global_batch)
    loud = mesh is None or mesh_lib.process_info()[0] == 0

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        state = train_lib.make_state(model, opt, gen, device)
        if mesh is None:
            return state
        return train_lib.shard_state(state, model, opt, mesh, tcfg.fsdp)

    losses, step_ms = [], []

    def step_fn(state, i):
        t0 = time.perf_counter()
        b = mt.batch(args.global_batch, args.seq, i)
        b = {k: torch.from_numpy(v[sl]).to(device) for k, v in b.items()}
        state, metrics = step(state, b, masks)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if loud:
            print(f"step {i} loss {losses[-1]:.4f}")
        return state

    out = ft.run_supervised(init_state, step_fn, n_steps=args.steps,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, injector=injector,
                            watchdog=ft.StragglerWatchdog(),
                            state_shardings=shardings, device=device)
    return {"losses": losses, "step_ms": step_ms, "result": out}


def main(argv=None):
    """CLI entry: supervised, checkpointed training (on every rank of the
    mesh, with ``--mesh``)."""
    args = parse_args(argv)
    cfg = make_config(args)
    got = run(args, cfg, args.device)
    losses, out = got["losses"], got["result"]
    if mesh_lib.process_info()[0] != 0:
        return 0
    if losses:
        print(f"finished {out['completed_steps']} steps; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
              f"restarts={out['restarts']}")
    else:
        print(f"finished {out['completed_steps']} steps (all restored); "
              f"restarts={out['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
