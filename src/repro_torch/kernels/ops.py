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

Gradients: the un-stacked gate (:func:`masked_act`,
:func:`masked_act_sited`) goes through :class:`MaskedActFn`, and the RWKV-6
scan (:func:`rwkv6`) through :class:`RWKV6ScanFn`, whenever autograd is
recording and an input requires a gradient, on the CPU and the card alike,
so the CPU tests exercise the backward rule the card runs.  Every stacked
or fused entry raises in that case (``masked_act.refuse_grad``): no
training path stacks candidates or fuses the gate into a product.
"""
from __future__ import annotations

import torch

from . import ref
from . import masked_act as K
from . import rwkv6_scan as RS

MASKED_ACT_FUSED_KINDS = ("relu", "gelu", "silu", "sqrelu")


class MaskedActFn(torch.autograd.Function):
    """The hard gate ``y = m·act(x) + (1−m)·g(x)`` over (rows, C), with its
    gradient for x and for poly (the mask gets none: hard masks are not
    trained).

    Forward: :func:`masked_act.masked_act_2d` (``gate_kernel``) on a CUDA
    tensor, ``ref.masked_act_ref`` on a CPU one.  Backward:
    :func:`masked_act.masked_act_2d_bwd` (``gate_bwd_kernel``) on a CUDA
    tensor, ``ref.masked_act_bwd_ref`` on a CPU one — the same rule, with
    JAX's derivatives at ties.  float32 only."""

    @staticmethod
    def forward(ctx, x, mask, poly, kind):
        if x.dtype != torch.float32:
            raise TypeError(f"MaskedActFn: the gate's gradient is float32 "
                            f"only, got {x.dtype}")
        if mask.requires_grad:
            raise RuntimeError("MaskedActFn: a hard mask gets no gradient; "
                               "train masks through the soft path")
        ctx.kind = kind
        ctx.save_for_backward(x, mask, poly)
        if x.is_cuda:
            return K.masked_act_2d(x.contiguous(), mask, poly, kind=kind)
        return ref.masked_act_ref(x, mask, kind=kind, poly=poly)

    @staticmethod
    def backward(ctx, g):
        x, mask, poly = ctx.saved_tensors
        need_dpoly = poly is not None and ctx.needs_input_grad[2]
        g = g.contiguous()
        if x.is_cuda:
            dx, dpoly = K.masked_act_2d_bwd(x.contiguous(), mask, g, poly,
                                            kind=ctx.kind,
                                            need_dpoly=need_dpoly)
        else:
            dx, dpoly = ref.masked_act_bwd_ref(x, mask, g, ctx.kind, poly,
                                               need_dpoly)
        return (dx if ctx.needs_input_grad[0] else None), None, dpoly, None


def masked_act(x, mask, *, kind: str = "relu", poly=None):
    """y = mask·act(x) + (1−mask)·g(x) over (..., C) with per-channel mask.

    Accepts any leading shape; flattens to (rows, C) for the kernel.  Under
    autograd (an input requires grad) the gate runs as
    :class:`MaskedActFn`, whose mask must then be (C,).
    """
    if ref.recording(x, mask, poly):
        out = MaskedActFn.apply(x.reshape(-1, x.shape[-1]), mask, poly,
                                kind)
        return out.view(x.shape)
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
    K.refuse_grad("masked_act_batched", x, masks, poly)
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
    K.refuse_grad("masked_act_conv3x3", x, mask, w)
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
    K.refuse_grad("masked_act_conv3x3_batched", x, masks, w)
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


def masked_act_matmul(x, mask, w, mul=None, *, kind: str = "relu"):
    """Fused ``gate(x) [· mul] @ w`` — a masked activation feeding a matrix
    product (the LM FFN's down-projection), the gated tensor never written
    to device memory.

    x: (..., K); mask: (K,), shared by every row, including rows that
    belong to different candidates; w: (K, N_out); mul: optional (..., K),
    the gated FFN's up branch.  On the CPU this is the unfused pair."""
    K.refuse_grad("masked_act_matmul", x, mask, w, mul)
    if not x.is_cuda:
        return ref.masked_act_matmul_ref(x, mask, w, mul, kind=kind)
    k = x.shape[-1]
    out = K.masked_act_matmul_2d(
        x.contiguous().view(-1, k), mask, w,
        None if mul is None else mul.contiguous().view(-1, k), kind=kind)
    return out.view(tuple(x.shape[:-1]) + (w.shape[-1],))


def masked_act_matmul_batched(x, masks, w, mul=None, *, kind: str = "relu"):
    """Stacked-candidate :func:`masked_act_matmul`: masks (N, K), one row
    per candidate; x and mul (N, ..., K); w shared.

    An activation that all candidates still share (the first FFN after a
    cached prefix) is passed as ``t.expand(N, ...)`` of the one (..., K)
    tensor: the stride-0 candidate axis reaches the kernel as it is, which
    reads the one copy N times, so the broadcast is never written."""
    n = masks.shape[0]
    for what, t in (("x", x), ("mul", mul)):
        if t is not None and t.shape[0] != n:
            raise ValueError(f"{what} {tuple(t.shape)} and masks "
                             f"{tuple(masks.shape)} disagree on N")
    K.refuse_grad("masked_act_matmul_batched", x, masks, w, mul)
    if not x.is_cuda:
        return ref.masked_act_matmul_batched_ref(x, masks, w, mul, kind=kind)
    k = x.shape[-1]
    out = K.masked_act_matmul_2d_batched(
        _rows_view(x, n, k), masks, w,
        None if mul is None else _rows_view(mul, n, k), kind=kind)
    return out.view(tuple(x.shape[:-1]) + (w.shape[-1],))


class RWKV6ScanFn(torch.autograd.Function):
    """The RWKV-6 scan over (BH, T, K/V) with its gradient for r, k, v, w,
    u and the initial state.

    Forward: :func:`rwkv6_scan.rwkv6_scan` (route C) on a CUDA tensor, the
    chunked plain version ``ref.rwkv6_scan_ref`` — the reference's
    arithmetic — on a CPU one.  Backward: :func:`rwkv6_scan.rwkv6_scan_bwd`
    (``rwkv6_scan_bwd_kernel``) on a CUDA tensor, ``ref.rwkv6_scan_bwd_ref``
    on a CPU one: the exact recurrence walked backward from saved states,
    which divides by no decay.  u's gradient comes in u's own shape, an
    (H, K) table's summed over each head's rows.  float32 only."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        if r.dtype != torch.float32:
            raise TypeError(f"RWKV6ScanFn: the scan's gradient is float32 "
                            f"only, got {r.dtype}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        if r.is_cuda:
            return RS.rwkv6_scan(r, k, v, w, u, state, chunk=chunk)
        return ref.rwkv6_scan_ref(r, k, v, w, u, state, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, ds_end):
        r, k, v, w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape[:2] + v.shape[-1:], dtype=r.dtype,
                             device=r.device)
        if r.is_cuda:
            grads = RS.rwkv6_scan_bwd(r, k, v, w, u, state, dy, ds_end,
                                      need_ds0=ctx.needs_input_grad[5])
        else:
            grads = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_end)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:6])) + (None,)


def rwkv6(r, k, v, w, u, state, *, chunk: int = 32):
    """The RWKV-6 linear-attention scan over (BH, T, K/V), float32.

    r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K), or the (H, K) per-head
    table when BH folds B·H heads; state: (BH, K, V).  Returns y
    (BH, T, V) and the new state.  T must be a multiple of ``chunk``, as
    in the reference.  A CPU tensor takes the chunked plain version, a
    CUDA tensor the hand-written kernel of the route
    ``rwkv6_scan.scan_route`` picks (``csrc/rwkv6_scan_sm90.cu``).  Under
    autograd (an input requires grad) the scan runs as
    :class:`RWKV6ScanFn`."""
    if ref.recording(r, k, v, w, u, state):
        return RWKV6ScanFn.apply(r, k, v, w, u, state, chunk)
    if not r.is_cuda:
        return ref.rwkv6_scan_ref(r, k, v, w, u, state, chunk=chunk)
    return RS.rwkv6_scan(r, k, v, w, u, state, chunk=chunk)
