"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``.  The reference lays a
``jax.sharding.Mesh`` over the devices of one jax program; the port runs one
process per rank and lays a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks, with the reference's axis names (``"cand"``, ``"batch"``,
``"data"``, ``"model"``, ``"pod"``) and its checks.  Functions, not
constants: importing this module touches no process group and no device.

**The process group** comes up once per process (:func:`init_process_group`,
called by every function below that makes a mesh):

- from the environment ``python -m torch.distributed.run`` sets (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
- or from a store the caller passes with its rank and world (the tests use
  a ``FileStore`` in a temporary directory, never a fixed port);
- or, in a plain one-process run, as a world of 1 on an in-process
  ``HashStore``: no launcher and no network.

**The backend, by one rule** (:func:`backend_for`): ``nccl`` where each rank
owns a card (a CUDA run with no more ranks than cards); ``gloo`` where ranks
share a card or run on the CPU.  NCCL refuses two ranks on one card, and
``gloo`` offers ``all_reduce`` and ``broadcast`` on CUDA tensors, which is
all the port's sharded evaluator uses.

``device="cuda"`` is the default; the CPU is used only when the caller asks
for it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np

DEFAULT_TIMEOUT_S = 300.0


def backend_for(device, world: int) -> str:
    """``"nccl"`` where each of ``world`` ranks owns a card, else
    ``"gloo"`` (ranks that share a card, or the CPU)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _card_index(rank: int) -> int:
    """The card a rank computes on: its ``LOCAL_RANK`` (else its rank),
    round the cards where ranks share them."""
    import torch
    local = int(os.environ.get("LOCAL_RANK", rank))
    return local % max(torch.cuda.device_count(), 1)


def init_process_group(device="cuda", *, store=None, rank: Optional[int] = None,
                       world: Optional[int] = None,
                       backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Bring up the default process group if it is not up; returns
    ``(rank, world)``.  ``store`` (with ``rank`` and ``world``) overrides
    the launcher's environment; with neither, a world of 1.  On the card
    the rank's device is set before the group (and any mesh) is built."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    kw = {}
    if store is not None:
        if rank is None or world is None:
            raise ValueError("a store needs rank= and world=")
        kw = dict(store=store, rank=int(rank), world_size=int(world))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kw = dict(init_method="env://", rank=rank, world_size=world)
    else:
        rank, world = 0, 1
        kw = dict(store=dist.HashStore(), rank=0, world_size=1)
    backend = backend or backend_for(device, world)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on the card needs a CUDA "
                               "device; pass device='cpu' for the CPU")
        torch.cuda.set_device(_card_index(rank))
        torch.cuda.init()
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return rank, world


def shutdown() -> None:
    """Tear the default process group down (no-op if it is not up)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(device, shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    init_process_group(device)
    n = int(np.prod(shape))
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"need {n} ranks, have {have}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's pod meshes: one pod (16, 16) ``data × model``, 256
    ranks; multi-pod (2, 16, 16) ``pod × data × model``, 512.  Raises,
    naming the rank count it needs, where the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """Small ``("data", "model")`` mesh over the first data·model ranks
    (tests and smoke runs)."""
    return _mesh(device, (data, model), ("data", "model"))


def make_candidate_mesh(n_devices: Optional[int] = None, device="cuda"):
    """1-D ``("cand",)`` mesh for BCD candidate-parallel evaluation
    (``core.engine.ShardedEvaluator``): the candidate axis of a stacked
    mask tree splits over it, params and data replicate.  Any rank count,
    1 included (the batched evaluator then)."""
    import torch.distributed as dist
    init_process_group(device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _mesh(device, (n,), ("cand",))


def make_cand_batch_mesh(cand: Optional[int] = None,
                         batch: Optional[int] = None, device="cuda"):
    """2-D ``("cand", "batch")`` mesh for joint candidate × batch BCD
    evaluation: small chunks split over ``"cand"`` while a batch-split
    evaluator context splits each forward over ``"batch"``; big chunks
    split jointly over both axes (chosen per call).  Give either factor;
    the other defaults to using every rank.  ``batch`` must divide the
    eval batch's leading dim."""
    import torch.distributed as dist
    init_process_group(device)
    n = dist.get_world_size()
    if cand is None and batch is None:
        cand, batch = n, 1
    elif cand is None:
        cand = n // batch
    elif batch is None:
        batch = n // cand
    if cand < 1 or batch < 1:
        raise ValueError(f"mesh factors must be >= 1, got ({cand}, {batch})")
    if cand * batch > n:
        raise ValueError(f"need {cand}x{batch} ranks, have {n}")
    return _mesh(device, (cand, batch), ("cand", "batch"))


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry data parallelism (batch sharding)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def process_info() -> tuple:
    """``(rank, world)`` of this process in the ``torch.distributed`` job,
    ``(0, 1)`` with no process group.

    The bridge to :mod:`repro_torch.launch.coordinator`: a launcher maps
    these onto ``REPRO_COORD_RANK`` / ``REPRO_COORD_WORLD``
    (:func:`coordinator_env`).  It brings no group up: launch-time code
    consults the coordinator's variables first (``coordinator.from_env``)
    and falls back here only where a group exists."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return int(dist.get_rank()), int(dist.get_world_size())


def coordinator_env() -> dict:
    """The coordinator's variables for this process: rank, world and, in a
    world of more than one, a session id that rank 0 draws and broadcasts
    (fresh per launch, the same on every rank)."""
    import time
    import torch.distributed as dist
    from repro_torch.launch import coordinator
    rank, world = process_info()
    env = {coordinator.ENV_RANK: str(rank), coordinator.ENV_WORLD: str(world)}
    if world > 1:
        box = [f"torch-{time.time_ns()}" if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        env[coordinator.ENV_SESSION] = box[0]
    return env


def join_sharded_run(device="cuda") -> Tuple[int, int]:
    """For an entry point run with ``--engine sharded``: bring the group up
    (a world of 1 without a launcher) and, where the launcher exported no
    coordinator, export this rank's (:func:`coordinator_env`), so rank 0
    alone writes files.  Returns ``(rank, world)``."""
    from repro_torch.launch import coordinator
    rank, world = init_process_group(device)
    if world > 1 and coordinator.ENV_WORLD not in os.environ:
        os.environ.update(coordinator_env())
    return rank, world


def broadcast_tree(tree, src: int = 0):
    """Overwrite every tensor leaf of ``tree`` in place with rank
    ``src``'s, so that every rank evaluates with the same bits (a no-op
    with no group or a world of 1).  Returns ``tree``."""
    import torch
    import torch.distributed as dist
    if process_info()[1] == 1:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            broadcast_tree(v, src)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            broadcast_tree(v, src)
    elif isinstance(tree, torch.Tensor):
        dist.broadcast(tree, src=src)
    return tree
