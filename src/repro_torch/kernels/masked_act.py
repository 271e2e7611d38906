"""Wrappers of the hand-written CUDA kernels (``csrc/masked_act.cu``).

Counterpart of ``repro/kernels/masked_act.py``.  Each wrapper checks device,
type, shape and contiguity, allocates its output with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its entry in :data:`launch_counts` — there and nowhere else.
The wrappers take CUDA tensors only; CPU tensors are served by
``kernels.ops`` through the plain versions in ``kernels.ref``.

Layouts are the reference's: activations ``(rows, C)`` / ``(N, rows, C)`` for
the gate, NHWC ``(B, H, W, Cin)`` / ``(N, B, H, W, Cin)`` and HWIO weights
for the fused convolution.  A stacked ``x`` may be an ``expand``-ed view with
candidate stride 0: the kernel then reads the one shared copy N times.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .ref import same_pads

KIND_CODES = {"relu": 0, "gelu": 1, "silu": 2, "sqrelu": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper since the last reset_launch_counts()
launch_counts = {
    "masked_act_2d": 0,
    "masked_act_2d_batched": 0,
    "masked_act_conv3x3": 0,
    "masked_act_conv3x3_batched": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _same_pads(size: int, stride: int):
    """XLA SAME-padding geometry for a 3-tap window: (out, lo, hi)."""
    return same_pads(size, stride, 3)


def _check_common(name: str, x: torch.Tensor, kind: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor (CPU tensors go "
                         "through kernels.ops, which uses the plain version)")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if kind not in KIND_CODES:
        raise ValueError(f"unknown activation {kind!r}")


def _f32_on(t: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    # may return a temporary; it can be dropped right after the launch
    # because PyTorch's allocator reuses a freed block only for later work
    # on the stream it was allocated on, which is the stream we launch on
    if t.device != like.device:
        raise ValueError(f"{name} lies on {t.device}, x on {like.device}")
    return t.to(torch.float32).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_gate(name, x, mask2, poly, out, n, rows, cols, x_cand_stride,
                 kind):
    dtype = _DTYPE_CODES[x.dtype]
    p = None
    if poly is not None:
        if poly.shape != (3, cols):
            raise ValueError(f"{name}: poly must be (3, {cols}), "
                             f"got {tuple(poly.shape)}")
        p = _f32_on(poly, x, "poly")
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.masked_act_gate_launch(
            x.data_ptr(), mask2.data_ptr(),
            None if p is None else p.data_ptr(), out.data_ptr(),
            n, rows, cols, x_cand_stride, KIND_CODES[kind], dtype,
            _stream(x))
    build.check(lib, code, name)
    launch_counts[name] += 1
    return out


def masked_act_2d(x: torch.Tensor, mask: torch.Tensor,
                  poly: Optional[torch.Tensor] = None, *,
                  kind: str = "relu") -> torch.Tensor:
    """Fused masked activation over a 2D (rows, channels) CUDA tensor.

    mask: (channels,) — 0/1, or any real weight.  poly: optional
    (3, channels) a, b, c of the replacement g(x) = a*x^2 + b*x + c; the
    identity when None.  Output has x's shape and dtype.
    """
    _check_common("masked_act_2d", x, kind)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("masked_act_2d: x must be a contiguous (rows, C) "
                         f"tensor, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    rows, cols = x.shape
    if mask.shape != (cols,):
        raise ValueError(f"masked_act_2d: mask must be ({cols},), "
                         f"got {tuple(mask.shape)}")
    out = torch.empty_like(x)
    return _launch_gate("masked_act_2d", x, _f32_on(mask, x, "mask"), poly,
                        out, 1, rows, cols, 0, kind)


def masked_act_2d_batched(x: torch.Tensor, mask: torch.Tensor,
                          poly: Optional[torch.Tensor] = None, *,
                          kind: str = "relu") -> torch.Tensor:
    """Fused masked activation over N stacked candidates.

    x: (N, rows, C), rows contiguous; the candidate stride may be 0 (an
    ``expand``-ed shared activation).  mask: (N, C), row b for candidate b.
    poly: optional (3, C), shared by the candidates.  Output is a fresh
    contiguous (N, rows, C) tensor.
    """
    name = "masked_act_2d_batched"
    _check_common(name, x, kind)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (N, rows, C), "
                         f"got {tuple(x.shape)}")
    n, rows, cols = x.shape
    if mask.shape != (n, cols):
        raise ValueError(f"{name}: mask must be ({n}, {cols}), "
                         f"got {tuple(mask.shape)}")
    inner_ok = (x.stride(2) == 1 or cols == 1) and \
        (x.stride(1) == cols or rows == 1)
    cand_ok = n == 1 or x.stride(0) in (0, rows * cols)
    if not (inner_ok and cand_ok):
        raise ValueError(f"{name}: x must be contiguous per candidate with "
                         "candidate stride rows*C or 0, got strides "
                         f"{x.stride()}")
    stride = 0 if n == 1 else x.stride(0)
    out = torch.empty((n, rows, cols), dtype=x.dtype, device=x.device)
    return _launch_gate(name, x, _f32_on(mask, x, "mask"), poly, out,
                        n, rows, cols, stride, kind)


def _launch_conv(name, x, mask, w, n, b, h, wd, cin, x_cand_stride,
                 mask_cand_stride, stride, kind, out_shape):
    dtype = _DTYPE_CODES[x.dtype]
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: w must be (3, 3, {cin}, Cout) HWIO, "
                         f"got {tuple(w.shape)}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"{name}: w must share x's device and dtype")
    w = w.contiguous()
    cout = w.shape[3]
    ho, plo_h, _ = _same_pads(h, stride)
    wo, plo_w, _ = _same_pads(wd, stride)
    out = torch.empty(out_shape + (ho, wo, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.masked_act_conv3x3_launch(
            x.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, b, h, wd, cin, cout, ho, wo, stride, plo_h, plo_w,
            x_cand_stride, mask_cand_stride, KIND_CODES[kind], dtype,
            _stream(x))
    build.check(lib, code, name)
    launch_counts[name] += 1
    return out


def masked_act_conv3x3(x: torch.Tensor, mask: torch.Tensor,
                       w: torch.Tensor, *, stride: int = 1,
                       kind: str = "relu") -> torch.Tensor:
    """Fused gate + SAME 3x3 conv: x (B, H, W, Cin) contiguous, mask
    (H, W, Cin) — the full per-pixel site mask, shared over the batch — w
    HWIO (3, 3, Cin, Cout).  Returns (B, Ho, Wo, Cout) in x's dtype."""
    name = "masked_act_conv3x3"
    _check_common(name, x, kind)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, H, W, Cin) "
                         f"tensor, got {tuple(x.shape)} {x.stride()}")
    b, h, wd, cin = x.shape
    if mask.shape != (h, wd, cin):
        raise ValueError(f"{name}: mask must be {(h, wd, cin)}, "
                         f"got {tuple(mask.shape)}")
    return _launch_conv(name, x, _f32_on(mask, x, "mask"), w, 1, b, h, wd,
                        cin, 0, 0, stride, kind, (b,))


def masked_act_conv3x3_batched(x: torch.Tensor, mask: torch.Tensor,
                               w: torch.Tensor, *, stride: int = 1,
                               kind: str = "relu") -> torch.Tensor:
    """Stacked-candidate :func:`masked_act_conv3x3`: x (N, B, H, W, Cin),
    contiguous per candidate, candidate stride B*H*W*Cin or 0 (shared);
    mask (N, H, W, Cin), one full site mask per candidate; w shared.
    Returns a fresh (N, B, Ho, Wo, Cout) tensor."""
    name = "masked_act_conv3x3_batched"
    _check_common(name, x, kind)
    if x.dim() != 5:
        raise ValueError(f"{name}: x must be (N, B, H, W, Cin), "
                         f"got {tuple(x.shape)}")
    n, b, h, wd, cin = x.shape
    if mask.shape != (n, h, wd, cin):
        raise ValueError(f"{name}: mask must be {(n, h, wd, cin)}, "
                         f"got {tuple(mask.shape)}")
    per = b * h * wd * cin
    if not x[0].is_contiguous() or not (n == 1 or x.stride(0) in (0, per)):
        raise ValueError(f"{name}: x must be contiguous per candidate with "
                         f"candidate stride {per} or 0, got {x.stride()}")
    xs = 0 if n == 1 else x.stride(0)
    return _launch_conv(name, x, _f32_on(mask, x, "mask"), w, n, b, h, wd,
                        cin, xs, h * wd * cin, stride, kind, (n, b))
