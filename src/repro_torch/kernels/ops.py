"""Public entry points for the kernels.

Counterpart of ``repro/kernels/ops.py``.  Dispatch policy: a tensor that
lies on the CPU takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback
from a kernel to the plain version.  Model code calls these wrappers only.

The candidate axis is explicit: the ``*_batched`` entries take stacked masks
``(N, ...)`` and activations that are either stacked ``(N, B, ...)`` or
still shared by all candidates ``(B, ...)``.  A shared activation is handed
to the kernel as a stride-0 view, so the ``(N, B, ...)`` broadcast is never
written.
"""
from __future__ import annotations

from . import ref
from . import masked_act as K

MASKED_ACT_FUSED_KINDS = ("relu", "gelu", "silu", "sqrelu")


def masked_act(x, mask, *, kind: str = "relu", poly=None):
    """y = mask·act(x) + (1−mask)·g(x) over (..., C) with per-channel mask.

    Accepts any leading shape; flattens to (rows, C) for the kernel.
    """
    if not x.is_cuda:
        return ref.masked_act_ref(x, mask, kind=kind, poly=poly)
    shape = x.shape
    out = K.masked_act_2d(x.contiguous().view(-1, shape[-1]), mask, poly,
                          kind=kind)
    return out.view(shape)


def masked_act_sited(x, mask, *, kind: str = "relu", poly=None):
    """Masked activation where the mask covers the full *site* shape.

    For CNNs the paper's mask is per (H, W, C) location shared over batch:
    x: (B, *site), mask: (*site).  Flattens site dims into the channel axis.
    """
    size = mask.numel()
    rows = x.numel() // size
    p2 = None if poly is None else poly.reshape(3, size)
    out = masked_act(x.reshape(rows, size), mask.reshape(-1), kind=kind,
                     poly=p2)
    return out.reshape(x.shape)


def masked_act_batched(x, masks, *, kind: str = "relu", poly=None):
    """Stacked-candidate masked activation (BCD's batched trial engine).

    x: (N, ..., C) — leading axis is the candidate axis (stride 0 allowed);
    masks: (N, C), one per-channel mask row per candidate.  poly: optional
    (3, C), shared across candidates.
    """
    n = masks.shape[0]
    if x.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)} and masks "
                         f"{tuple(masks.shape)} disagree on N")
    if not x.is_cuda:
        m = masks.reshape((n,) + (1,) * (x.dim() - 2) + (masks.shape[-1],))
        return ref.masked_act_ref(x, m, kind=kind, poly=poly)
    out = K.masked_act_2d_batched(_rows_view(x, n, x.shape[-1]), masks, poly,
                                  kind=kind)
    return out.view(x.shape)


def _rows_view(x, n: int, cols: int):
    """(N, ..., C) -> (N, rows, C) without writing a broadcast: a stride-0
    candidate axis stays stride 0."""
    if n > 1 and x.stride(0) == 0:
        return x[0].contiguous().view(1, -1, cols).expand(n, -1, -1)
    return x.contiguous().view(n, -1, cols)


def masked_act_sited_batched(x, masks, *, kind: str = "relu", poly=None):
    """Batched :func:`masked_act_sited`: stacked site masks.

    masks: (N, *site).  x: (N, B, *site) activations per candidate, or
    (B, *site) when the activation is still shared by all candidates (the
    first gate after a cached prefix or the cached stem fold).
    """
    n = masks.shape[0]
    site_size = masks.numel() // n
    site_dims = masks.dim() - 1
    if x.dim() == site_dims + 1:          # shared activation
        x = x.unsqueeze(0).expand((n,) + tuple(x.shape))
    p2 = None if poly is None else poly.reshape(3, site_size)
    out = masked_act_batched(_rows_view(x, n, site_size),
                             masks.reshape(n, site_size), kind=kind, poly=p2)
    return out.reshape(x.shape)


def masked_act_conv3x3(x, mask, w, *, stride: int = 1, kind: str = "relu"):
    """Fused ``conv3x3(gate(x))`` — a CNN's masked ReLU feeding a SAME 3x3
    conv, the gated tensor never written to device memory.

    x: (B, H, W, Cin); mask: (H, W, Cin) full per-pixel site mask; w HWIO.
    On the CPU this is the unfused pair (gate, pad, ``F.conv2d``)."""
    if not x.is_cuda:
        return ref.masked_act_conv3x3_ref(x, mask, w, stride=stride,
                                          kind=kind)
    return K.masked_act_conv3x3(x.contiguous(), mask, w, stride=stride,
                                kind=kind)


def masked_act_conv3x3_batched(x, masks, w, *, stride: int = 1,
                               kind: str = "relu"):
    """Stacked-candidate :func:`masked_act_conv3x3`: masks (N, H, W, Cin);
    x (N, B, H, W, Cin), or (B, H, W, Cin) when still shared by the
    candidates; w shared."""
    n = masks.shape[0]
    if not x.is_cuda:
        # the plain version broadcasts a shared x against (N, 1, ...) masks
        return ref.masked_act_conv3x3_ref(x, masks, w, stride=stride,
                                          kind=kind)
    if x.dim() == 4:
        x = x.contiguous().unsqueeze(0).expand((n,) + tuple(x.shape))
    elif not (x.stride(0) == 0 and x[0].is_contiguous()):
        x = x.contiguous()
    return K.masked_act_conv3x3_batched(x, masks, w, stride=stride,
                                        kind=kind)

