"""Fault-tolerant checkpointing: atomic step directories, per-leaf sha256.

Counterpart of ``repro/training/checkpoint.py``, with its on-disk format
byte for byte, so that a checkpoint written by either package restores in
the other:

    ckpt_dir/step_00000123.tmp/ ... -> atomic rename -> ckpt_dir/step_00000123/
        manifest.json      {step, meta, leaves, treedef}
        leaf_00000.npy     one file per leaf

A tree is a nested dict / list / tuple / namedtuple of arrays (tensors on
any device, numpy arrays, scalars); None holds no leaf.  A leaf's key is its
path joined by ``/`` (dict keys, sequence indices and namedtuple field names
as strings, as the reference's ``_key_part`` takes them), and files are
numbered in the order of the **sorted key strings** (``params/w/10`` before
``params/w/2``), not in the order of the tree walk.  The manifest records
each leaf's file, shape, dtype and sha256, the caller's ``meta``, and the
tree's structure as ``jax.tree_util`` prints it (:func:`treedef_str`), so the
same state gives the same :func:`manifest_fingerprint` in both packages.

A bfloat16 leaf (a tensor, or a numpy array of ``ml_dtypes``' bfloat16,
which the reference's trees hold) is written as the reference writes one:
``np.save`` of an ``ml_dtypes`` array gives an ``.npy`` whose header says
``'descr': '<V2'``, followed by the raw 16-bit payload, and the manifest
records ``"dtype": "bfloat16"``.  The port writes that header itself
(numpy alone would say ``'|V2'``, and the card's machine has no
``ml_dtypes``), so the files are byte-identical, and reads such a leaf's
payload as ``int16`` and views it as ``torch.bfloat16`` — never through
float32.

Multi-host policy: a checkpoint directory has exactly ONE writer (rank 0 of
the job's :mod:`repro_torch.launch.coordinator`).  :func:`save` enforces
this when handed a coordinator; reader ranks follow the writer's lineage
with :func:`wait_for_step` and prove they restored the same checkpoint by
comparing :func:`manifest_fingerprint` values.

Sharded states (``shardings=``, a ``launch.mesh.Shardings``): :func:`save`
gathers each leaf whole, leaf by leaf on every rank, and rank 0 of the
process group writes the same files, manifest and sha256 as a one-process
save of the same values; :func:`restore` is the reference's elastic
restore, each rank reading only its slice of each leaf (``np.load`` with
``mmap_mode="r"``), so a checkpoint saved on one mesh restores onto any
other, or onto one process.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
# leaf files hashed at once: hashlib releases the GIL while it hashes a
# block, so a checkpoint of many leaves hashes on several cores
_HASH_THREADS = min(8, os.cpu_count() or 1)


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be trusted: missing leaf files,
    unreadable/mismatched manifest, or a leaf whose bytes fail the
    manifest's sha256 — the restore path refuses partial state rather than
    resuming a run from silently corrupted arrays.  Also raised for a tree
    this format cannot hold (a node type other than dict, list, tuple,
    namedtuple or None)."""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _sha256_files(paths: List[str]) -> Dict[str, Future]:
    """Each existing file of ``paths`` hashed on ``_HASH_THREADS``
    threads; returns when all are done, a future per path (its digest, or
    the error hashing it raised, from ``result()``).  Callers still check
    their leaves in order, so the first bad leaf is the one reported."""
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        return {p: pool.submit(_file_sha256, p) for p in dict.fromkeys(paths)
                if os.path.exists(p)}


def _hashed_leaf_files(d: str, infos) -> List[str]:
    """The files of the manifest entries ``infos`` that record a sha256
    (entries of another form are left to the caller's own checks)."""
    return [os.path.join(d, v["file"]) for v in infos
            if isinstance(v, dict) and v.get("sha256")
            and isinstance(v.get("file"), str)]


def _node_kind(t) -> Optional[str]:
    """'dict' / 'list' / 'tuple' / 'namedtuple' / 'none' for a container
    node, None for a leaf.  A namedtuple flattens by its fields, in their
    order, as ``jax.tree_util`` flattens it; other subclasses
    (OrderedDict, a tuple subclass without ``_fields``) flatten differently
    there and are refused."""
    if t is None:
        return "none"
    if isinstance(t, tuple) and hasattr(type(t), "_fields"):
        return "namedtuple"
    for kind, typ in (("dict", dict), ("list", list), ("tuple", tuple)):
        if type(t) is typ:
            return kind
        if isinstance(t, typ):
            raise CheckpointError(
                f"unsupported tree node {type(t).__name__}: checkpoints "
                "hold nested dict / list / tuple / namedtuple / None only")
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in ``jax.tree_util``'s order: dict keys sorted,
    sequences by index, namedtuples by field (keyed by the field's name),
    None skipped."""
    kind = _node_kind(tree)
    if kind == "dict":
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if kind == "namedtuple":
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _flatten(v, prefix + (f,))]
    if kind in ("list", "tuple"):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    if kind == "none":
        return []
    return [(_SEP.join(prefix), tree)]


def _rebuild(template, out: dict, prefix: Tuple[str, ...] = ()):
    """``template``'s structure, its own node types included, with the leaf
    at each key taken from ``out``."""
    kind = _node_kind(template)
    if kind == "dict":
        return {k: _rebuild(v, out, prefix + (str(k),))
                for k, v in template.items()}
    if kind == "namedtuple":
        return type(template)(*(_rebuild(v, out, prefix + (f,))
                                for f, v in zip(template._fields, template)))
    if kind in ("list", "tuple"):
        return type(template)(_rebuild(v, out, prefix + (str(i),))
                              for i, v in enumerate(template))
    if kind == "none":
        return None
    return out[_SEP.join(prefix)]


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it: ``PyTreeDef({'a': *, 'b': [*, (*, None)]})`` — dict keys
    sorted and ``repr``'d, ``*`` for a leaf, ``(*,)`` for a 1-tuple, and a
    namedtuple as ``CustomNode(namedtuple[Name], [field, …])``."""
    def fmt(t) -> str:
        kind = _node_kind(t)
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if kind == "list":
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        if kind == "namedtuple":
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(fmt(v) for v in t) + "])")
        if kind == "tuple":
            body = ", ".join(fmt(v) for v in t)
            return "(" + body + ("," if len(t) == 1 else "") + ")"
        if kind == "none":
            return "None"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


_BF16 = "bfloat16"
_BF16_DESCR = "<V2"          # what np.save writes for ml_dtypes' bfloat16


def _c_order(arr: np.ndarray) -> np.ndarray:
    # ``np.ascontiguousarray`` would make a 0-d leaf 1-d
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array the reference would write, and the dtype
    its manifest records: a tensor is copied to the host (which waits for
    the device), C-contiguous, as ``jax.device_get`` gives it; anything
    else goes through ``np.asarray``.  A bfloat16 leaf comes back as its
    16-bit payload viewed as ``int16``, with the dtype ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == _BF16:
        return _c_order(arr).view(np.int16), _BF16
    return arr, str(arr.dtype)


def _write_leaf(fpath: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``'s file; a bfloat16 payload under the header the
    reference's ``np.save`` of an ``ml_dtypes`` array writes."""
    if dtype != _BF16:
        np.save(fpath, arr)
        return
    with open(fpath, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        arr.tofile(f)


def _leaf_tensor(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A loaded leaf as a tensor on the host: a bfloat16 leaf's 2-byte
    payload (``'<V2'`` on disk) viewed as ``int16`` and then as
    ``torch.bfloat16``, bit for bit."""
    if dtype != _BF16:
        return torch.from_numpy(arr)
    if arr.dtype.itemsize != 2:
        raise ValueError(f"a bfloat16 leaf holds 2-byte items, the file "
                         f"holds {arr.dtype}")
    return torch.from_numpy(_c_order(arr).view(np.int16)) \
        .view(torch.bfloat16)


def _flatten_specs(specs, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """A placement tree's ``spmd.Spec`` leaves by their keys, as
    :func:`_flatten` keys a state's leaves."""
    from repro_torch.core import spmd
    if isinstance(specs, spmd.Spec):
        return {_SEP.join(prefix): specs}
    out = {}
    if isinstance(specs, dict):
        for k in specs:
            out.update(_flatten_specs(specs[k], prefix + (str(k),)))
    elif isinstance(specs, tuple) and hasattr(type(specs), "_fields"):
        for f, v in zip(specs._fields, specs):
            out.update(_flatten_specs(v, prefix + (f,)))
    elif isinstance(specs, (list, tuple)):
        for i, v in enumerate(specs):
            out.update(_flatten_specs(v, prefix + (str(i),)))
    return out


def _sharded_arrays(flat, shardings, writer: bool) -> dict:
    """Every leaf gathered whole over the mesh, leaf by leaf in key order
    on every rank; the writer keeps each as its host array."""
    from repro_torch.core import spmd
    from repro_torch.launch import mesh as mesh_lib
    specs = _flatten_specs(shardings.specs)
    arrays = {}
    for key, leaf in sorted(flat, key=lambda kv: kv[0]):
        whole = mesh_lib.gather_tree(leaf, specs.get(key, spmd.Spec()),
                                     shardings.mesh)
        if writer:
            arrays[key] = _host_array(whole)
        del whole
    return arrays


def save(state, ckpt_dir: str, step: int, *, meta: Optional[dict] = None,
         keep: int = 3, coordinator=None, shardings=None) -> str:
    """Atomic checkpoint write.  Returns the final directory.

    ``state`` is a nested dict / list / tuple of tensors (CUDA or CPU),
    numpy arrays or scalars; every leaf lands as one ``.npy`` with its
    sha256 recorded in the manifest, and the whole step directory becomes
    visible in a single rename (readers never observe a partial step).
    ``keep`` garbage-collects the oldest step directories past that count.

    ``coordinator`` (optional, a :mod:`repro_torch.launch.coordinator`
    object) enforces the single-writer policy: a non-writer rank calling
    this raises :class:`CheckpointError` before any bytes are written —
    reader ranks must :func:`wait_for_step` instead.

    ``shardings`` (a ``launch.mesh.Shardings``): ``state`` holds this
    rank's shards.  Every rank calls ``save``; each leaf is gathered whole
    and rank 0 of the process group writes; every rank returns once the
    step directory is committed.
    """
    if coordinator is not None and not coordinator.is_writer:
        raise CheckpointError(
            f"rank {coordinator.rank} is not the writer (rank 0 of "
            f"{coordinator.world_size}): only the writer commits "
            f"checkpoints to {ckpt_dir}; readers wait_for_step()")
    flat = _flatten(state)
    treedef = treedef_str(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is not None:
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib
        writer = mesh_lib.process_info()[0] == 0
        arrays = _sharded_arrays(flat, shardings, writer)
        if writer:
            _commit(arrays, treedef, ckpt_dir, step, meta, keep)
        if mesh_lib.process_info()[1] > 1:
            dist.barrier()
        return final
    arrays = {key: _host_array(leaf) for key, leaf in flat}
    return _commit(arrays, treedef, ckpt_dir, step, meta, keep)


def _commit(arrays: dict, treedef: str, ckpt_dir: str, step: int,
            meta: Optional[dict], keep: int) -> str:
    """Write the step directory from host arrays (key -> (array, dtype))
    and rename it into place."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "meta": meta or {}, "leaves": {},
                "treedef": treedef}
    # each leaf is hashed from its file while the next ones are written
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        digests = {}
        for i, key in enumerate(sorted(arrays)):
            arr, dtype = arrays[key]
            fname = f"leaf_{i:05d}.npy"
            fpath = os.path.join(tmp, fname)
            _write_leaf(fpath, arr, dtype)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha256": None}
            digests[key] = pool.submit(_file_sha256, fpath)
    for key, digest in digests.items():
        manifest["leaves"][key]["sha256"] = digest.result()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomicity point
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> List[int]:
    return [int(m.group(1)) for d in os.listdir(ckpt_dir)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step directory present (no validity check) or None.

    Prefer :func:`latest_valid_step` for resume decisions — a crash can
    leave the newest step present but unusable.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def manifest_fingerprint(ckpt_dir: str, step: int) -> str:
    """sha256 over a checkpoint's canonicalized manifest (sorted keys,
    tight separators).

    The manifest pins every leaf's bytes (per-leaf sha256), shapes, dtypes,
    the tree's structure and the run meta — so two checkpoints with equal
    fingerprints describe bit-identical state.  Multi-host restores compare
    it across ranks: the writer broadcasts its fingerprint and every reader
    verifies it resumed the SAME lineage, not merely the same step number.
    """
    manifest = read_manifest(ckpt_dir, step)
    blob = json.dumps(manifest, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def wait_for_step(ckpt_dir: str, step: int, *, timeout_s: float = 300.0,
                  poll_s: float = 0.05) -> int:
    """Block until a valid checkpoint at ``>= step`` exists; return its step.

    The reader side of the single-writer policy: non-writer ranks call this
    where the writer calls :func:`save`.  Polls :func:`latest_valid_step`
    shallowly — content trust comes from the restore path's hash
    verification.  Raises :class:`CheckpointError` when the timeout expires
    (dead writer).
    """
    deadline = time.monotonic() + timeout_s
    while True:
        got = latest_valid_step(ckpt_dir, deep=False)
        if got is not None and got >= step:
            return got
        if time.monotonic() > deadline:
            raise CheckpointError(
                f"timed out after {timeout_s:.0f}s waiting for checkpoint "
                f"step >= {step} in {ckpt_dir} (newest valid: {got}) — "
                "writer rank dead or stalled")
        time.sleep(poll_s)


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Load + sanity-check a checkpoint's manifest (incl. its ``meta``)."""
    mf = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    if not os.path.exists(mf):
        raise CheckpointError(f"no manifest at {mf}")
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointError(f"unreadable manifest {mf}: {e}") from e
    if "leaves" not in manifest:
        raise CheckpointError(f"manifest {mf} has no leaves table")
    return manifest


def restore(state_template, ckpt_dir: str, step: Optional[int] = None,
            shardings=None, *, device="cuda", verify: bool = True):
    """Restore into the structure of ``state_template``: returns ``(tree,
    step)``, every leaf a tensor on ``device`` with the dtype on disk (the
    manifest's ``"bfloat16"`` a ``torch.bfloat16`` leaf).

    Only the leaves the template names are read (a checkpoint may hold
    more).  ``verify`` checks each leaf file against the manifest's sha256
    before use; corruption raises :class:`CheckpointError` instead of
    handing the caller partial state.

    ``shardings`` (a ``launch.mesh.Shardings`` over the template's tree):
    the reference's elastic restore — each leaf is this rank's shard of
    it, read from the file's slice alone, whatever mesh saved it.
    """
    specs = _flatten_specs(shardings.specs) if shardings is not None \
        else None
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir, step)
    keys = [key for key, _ in _flatten(state_template)]
    digests = _sha256_files(_hashed_leaf_files(
        d, [manifest["leaves"].get(key) for key in keys])) if verify else {}
    out = {}
    for key in keys:
        if key not in manifest["leaves"]:
            raise CheckpointError(
                f"checkpoint {d} is missing leaf {key!r} required by the "
                "restore template")
        info = manifest["leaves"][key]
        fpath = os.path.join(d, info["file"])
        if not os.path.exists(fpath):
            raise CheckpointError(f"checkpoint {d}: leaf file {info['file']} "
                                  "is missing (partial write?)")
        if verify and info.get("sha256") and \
                digests[fpath].result() != info["sha256"]:
            raise CheckpointError(
                f"checkpoint {d}: leaf {key!r} ({info['file']}) fails its "
                "manifest sha256 — corrupted on disk")
        try:
            if specs is not None and key in specs and info.get("shape"):
                from repro_torch.launch import mesh as mesh_lib
                arr = mesh_lib.shard_tree(np.load(fpath, mmap_mode="r"),
                                          specs[key], shardings.mesh)
            else:
                arr = np.load(fpath)
            t = _leaf_tensor(arr, info.get("dtype"))
        except (ValueError, OSError, EOFError) as e:
            raise CheckpointError(
                f"checkpoint {d}: leaf {key!r} unreadable: {e}") from e
        out[key] = t.to(device)
    return _rebuild(state_template, out), step


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def validate(ckpt_dir: str, step: int, *, deep: bool = False) -> bool:
    """A checkpoint is valid iff its manifest and all leaf files exist;
    ``deep`` additionally re-hashes every leaf against the manifest's
    sha256 (catches truncated/bit-rotted files, not just missing ones)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        manifest = read_manifest(ckpt_dir, step)
    except CheckpointError:
        return False
    try:
        leaves = list(manifest["leaves"].values())
        digests = _sha256_files(_hashed_leaf_files(d, leaves)) if deep \
            else {}
        for v in leaves:
            fpath = os.path.join(d, v["file"])
            if not os.path.exists(fpath):
                return False
            if deep and v.get("sha256") and \
                    digests[fpath].result() != v["sha256"]:
                return False
    except (KeyError, TypeError):
        return False
    return True


def latest_valid_step(ckpt_dir: str, *, deep: bool = True) -> Optional[int]:
    """Newest step that passes :func:`validate` — the resume point.  Scans
    descending so a crash that corrupted only the newest checkpoint falls
    back to the one before it."""
    if not os.path.isdir(ckpt_dir):
        return None
    for s in sorted(_steps(ckpt_dir), reverse=True):
        if validate(ckpt_dir, s, deep=deep):
            return s
    return None
