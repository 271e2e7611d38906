"""Conversion between the reference package's trees and the port's.

The reference keeps parameters as a nested dict (pytree) of arrays; the port
keeps the same nested dict, same keys and layouts (NHWC activations, HWIO
conv weights), with torch tensors as leaves.  Both sides exchange numpy
arrays, so that the two packages compute the same thing from the same
numbers; nothing of the reference package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch


def leaf_to_device(value, device="cuda", dtype=None) -> torch.Tensor:
    """One array (numpy or anything ``np.asarray`` takes) or tensor as a
    tensor on ``device``.  The result never shares memory with a numpy
    array: on the CPU it is a copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value, dtype=dtype)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)          # the port's working type
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        return torch.from_numpy(np.array(arr, order="C")).to(device)
    t = torch.from_numpy(arr)
    return t.clone() if torch.device(device).type == "cpu" else t.to(device)


def to_device(tree, device="cuda"):
    """A nested dict / list / tuple of numpy arrays or tensors -> the same
    structure with every leaf a tensor on ``device`` (dtypes kept, float64
    excepted: it becomes float32, the port's working type)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return leaf_to_device(tree, device)


def _reference_leaf(value, device, dtype) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to share
        # memory with: widen exactly to float32, then narrow back
        t = leaf_to_device(arr.astype(np.float32), device).to(torch.bfloat16)
    else:
        t = leaf_to_device(arr, device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_reference(tree, device="cuda", dtype=torch.float32, *,
                          specs=None, mesh=None):
    """The reference's parameter pytree, leaves as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's parameter tree on
    ``device``: the same nested dicts, lists and tuples.

    ``dtype``: every floating leaf is cast to it (float32 by default);
    ``None`` keeps each leaf's own type, so a bfloat16 model keeps its
    bfloat16 weights beside its float32 norm scales.

    ``specs`` (a placement tree, e.g. ``models.lm.held_param_specs``) with
    ``mesh``: each leaf is cut to this rank's shard on the host
    (``launch.mesh.shard_tree``) before it is placed on ``device``."""
    if specs is not None:
        from repro_torch.launch import mesh as mesh_lib
        tree = mesh_lib.shard_tree(_to_numpy(tree), specs, mesh)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device, dtype)
                          for v in tree)
    return _reference_leaf(tree, device, dtype)


def masks_from_reference(masks, device="cuda"):
    """A reference mask tree (site -> 0/1/TIE array, stacked or not) as
    float32 tensors on ``device``."""
    return {k: leaf_to_device(v, device, np.float32)
            for k, v in masks.items()}


def _to_numpy(tree):
    """Leaves as numpy arrays (a tensor copied to the host, as its
    bits)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)
