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


def params_from_reference(tree, device="cuda"):
    """The reference's parameter pytree, leaves as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's parameter dict on
    ``device``, float32."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return leaf_to_device(tree, device, np.float32)


def masks_from_reference(masks, device="cuda"):
    """A reference mask tree (site -> 0/1/TIE array, stacked or not) as
    float32 tensors on ``device``."""
    return {k: leaf_to_device(v, device, np.float32)
            for k, v in masks.items()}
