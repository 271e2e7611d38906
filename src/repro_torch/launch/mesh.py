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
from typing import NamedTuple, Optional, Tuple

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
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# meshes made over a process group, by the group, device type, shape and
# axis names: each new mesh makes process groups for its axes, which every
# rank must make alike, so a shape asked for again is served from here
_MESHES = {}


def _mesh(device, shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    # checked before a group comes up: a mesh larger than the world is
    # refused, never shrunk
    have = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", 1))
    if n > have:
        raise ValueError(f"need {n} ranks, have {have}")
    init_process_group(device)
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"need {n} ranks, have {have}")
    world = dist.group.WORLD
    key = (id(world), torch.device(device).type, tuple(shape), tuple(names))
    if key not in _MESHES:
        # the group is kept with its mesh, so that its id is not reused
        _MESHES[key] = (world, DeviceMesh(
            key[1], torch.arange(n).reshape(shape), mesh_dim_names=names))
    return _MESHES[key][1]


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


# --------------------------------------------------- placements over a mesh
#
# A placement tree mirrors a parameter (or cache, or train-state) tree: each
# leaf is a ``spmd.Spec``, a tuple with one entry per dimension of the leaf,
# a mesh axis name, a tuple of names, or None (whole along that dimension);
# ``Spec()`` is a leaf every rank holds whole.  ``shard_tree`` cuts whole
# tensors to this rank's pieces, ``gather_tree`` puts the pieces back.


class Shardings(NamedTuple):
    """A placement tree over a mesh: what the reference's trees of
    ``NamedSharding`` say (``training.checkpoint.save`` / ``restore``
    ``shardings=``, ``training.ft.run_supervised(state_shardings=)``)."""

    mesh: object
    specs: object


def axis(mesh, name: str):
    """Mesh axis ``name`` as this rank sees it (``spmd.Axis``): its group,
    size and this rank's coordinate.  An axis the mesh lacks, or no mesh,
    is an axis of one rank."""
    from repro_torch.core import spmd
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return spmd.Axis(name, None, 1, 0)
    size = int(mesh.size(mesh.mesh_dim_names.index(name)))
    index = int(mesh.get_local_rank(name))
    group = mesh.get_group(name) if size > 1 else None
    return spmd.Axis(name, group, size, index)


def axis_group(mesh, name: str):
    """The process group of mesh axis ``name`` (None for one rank); this
    rank's coordinate and range along it are ``axis(mesh, name).index`` and
    ``.span(n)``."""
    return axis(mesh, name).group


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _walk(tree, specs, leaf_fn):
    from repro_torch.core import spmd
    if isinstance(specs, spmd.Spec):
        return None if tree is None else leaf_fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], leaf_fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_walk(v, s, leaf_fn)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, s, leaf_fn) for v, s in zip(tree, specs))
    raise TypeError(f"placement tree does not match the tree at "
                    f"{type(tree).__name__}")


def shard_tree(tree, specs, mesh):
    """Each leaf of ``tree`` (whole tensors) cut to this rank's piece of
    its placement in ``specs`` (a tree of ``spmd.Spec``, the same
    structure; a None leaf stays None).  Leaves are tensors or numpy
    arrays (cut before they reach a device); slices are copies."""
    import torch

    def cut(t, spec):
        if not isinstance(t, (torch.Tensor, np.ndarray)):
            return t
        for dim, entry in enumerate(spec):
            # a tuple of axes splits in mesh order: the first named axis
            # is the slowest
            for name in _entry_axes(entry):
                ax = axis(mesh, name)
                if ax.size > 1:
                    lo, hi = ax.span(t.shape[dim])
                    index = [slice(None)] * t.ndim
                    index[dim] = slice(lo, hi)
                    t = t[tuple(index)]
        if isinstance(t, np.ndarray):
            return np.array(t, order="C")
        return t.contiguous().clone()
    return _walk(tree, specs, cut)


def gather_tree(tree, specs, mesh):
    """The inverse of :func:`shard_tree`: every leaf whole on every rank
    (an ``all_reduce`` of zero-filled tensors per sharded axis)."""
    import torch
    from repro_torch.core import spmd

    def whole(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        for dim, entry in enumerate(spec):
            for name in reversed(_entry_axes(entry)):
                t = spmd.all_gather_dim(t, dim, axis(mesh, name))
        return t
    return _walk(tree, specs, whole)


