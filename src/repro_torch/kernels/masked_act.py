"""Wrappers of the hand-written CUDA kernels (``csrc/masked_act.cu``,
``csrc/masked_act_conv_sm90.cu``, ``csrc/masked_act_matmul.cu`` and
``csrc/masked_act_matmul_sm90.cu``).

Counterpart of ``repro/kernels/masked_act.py``.  Each wrapper checks device,
type, shape and contiguity, allocates its output with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its entry in :data:`build.launch_counts`
(:func:`build.count_launch`) — there and nowhere else.
The wrappers take CUDA tensors only; CPU tensors are served by
``kernels.ops`` through the plain versions in ``kernels.ref``.

No wrapper is differentiable: each raises (:func:`refuse_grad`) when a
gradient is being recorded and an input requires one, instead of returning
a result cut off from the graph.  The one gate with a gradient is
``ops.MaskedActFn``, whose forward is :func:`masked_act_2d` and whose
backward is :func:`masked_act_2d_bwd` (``gate_bwd_kernel``).

Layouts are the reference's: activations ``(rows, C)`` / ``(N, rows, C)`` for
the gate, NHWC ``(B, H, W, Cin)`` / ``(N, B, H, W, Cin)`` and HWIO weights
for the fused convolution, ``(rows, K)`` / ``(N, rows, K)`` activations and
``(K, N_out)`` weights for the fused matrix product.  A stacked ``x`` (and
the fused product's ``mul``) may be an ``expand``-ed view with candidate
stride 0: the kernel then reads the one shared copy N times.

The fused matrix product has two routes, picked by :func:`matmul_route` and
nothing else: ``"wgmma"`` (bfloat16 on the tensor cores) and ``"fma"``
(float32 FMA, every other call).  The fused convolution has two, picked by
:func:`conv_route`: ``"tf32x3"`` (float32 on the tensor cores, each operand
split into two TF32 parts) and ``"fma"`` (float32 FMA, every other call).
A route the kernel library cannot take raises; no call falls back to
another route or to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .ref import recording, same_pads

KIND_CODES = {"relu": 0, "gelu": 1, "silu": 2, "sqrelu": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MATMUL_ROUTES = {"fma": 0, "wgmma": 1}
CONV_ROUTES = {"fma": 0, "tf32x3": 1}
_TMA_ROWS = 2 ** 31         # a TMA coordinate is a signed 32-bit integer


def _same_pads(size: int, stride: int):
    """XLA SAME-padding geometry for a 3-tap window: (out, lo, hi)."""
    return same_pads(size, stride, 3)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd is recording and one of ``tensors`` (None is
    skipped) requires a gradient: the kernel's result would carry no
    ``grad_fn``, and every parameter upstream would silently get none."""
    if recording(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            "backward (only the un-stacked gate does, through "
            "kernels.ops.MaskedActFn); run it under torch.no_grad(), or "
            "call the model with fused=False and one mask tree")


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
    build.count_launch(name)
    return out


def masked_act_2d(x: torch.Tensor, mask: torch.Tensor,
                  poly: Optional[torch.Tensor] = None, *,
                  kind: str = "relu") -> torch.Tensor:
    """Fused masked activation over a 2D (rows, channels) CUDA tensor.

    mask: (channels,) — 0/1, or any real weight.  poly: optional
    (3, channels) a, b, c of the replacement g(x) = a*x^2 + b*x + c; the
    identity when None.  Output has x's shape and dtype.
    """
    refuse_grad("masked_act_2d", x, mask, poly)
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


def bwd_stripes(rows: int):
    """``(stripes, rows_per_stripe)`` of the gate's backward: every thread
    walks its column through one stripe of rows, in order.  A function of
    the row count alone, so the poly reduction adds in the same order
    whatever the alignment or the column count (at least 4 rows a thread,
    at most 65535 stripes, the grid's y limit)."""
    per = max(4, -(-rows // 65535))
    return -(-rows // per), per


def masked_act_2d_bwd(x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                      poly: Optional[torch.Tensor] = None, *,
                      kind: str = "relu", need_dpoly: bool = False):
    """The gradient of :func:`masked_act_2d` (``gate_bwd_kernel``).

    x, g: contiguous (rows, C) CUDA tensors of one dtype, float32 or
    bfloat16 (g the gradient of the gate's output); mask (C,); poly None or
    (3, C).  Returns ``(dx, dpoly)``: dx (rows, C) in x's dtype, and dpoly
    (3, C) in poly's dtype — the poly coefficients' gradient, summed over
    the rows in a fixed order — when ``need_dpoly`` (which needs poly),
    else None.  The arithmetic is float32 whatever the dtype, and each
    result is rounded once.  Derivatives at ties as JAX takes them
    (``kernels/ref.py``); the plain version is ``ref.masked_act_bwd_ref``.
    """
    name = "masked_act_2d_bwd"
    refuse_grad(name, x, mask, g, poly)
    _check_common(name, x, kind)
    if g.dtype != x.dtype:
        raise TypeError(f"{name}: x and g must have one dtype, got {x.dtype} "
                        f"and {g.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or g.shape != x.shape or \
            not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"{name}: x and g must be contiguous (rows, C) "
                         f"tensors of one shape on one device, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    rows, cols = x.shape
    if mask.shape != (cols,):
        raise ValueError(f"{name}: mask must be ({cols},), "
                         f"got {tuple(mask.shape)}")
    if poly is not None and poly.shape != (3, cols):
        raise ValueError(f"{name}: poly must be (3, {cols}), "
                         f"got {tuple(poly.shape)}")
    if need_dpoly and poly is None:
        raise ValueError(f"{name}: need_dpoly without poly")
    if need_dpoly and poly.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: poly must be float32 or bfloat16 for "
                        f"need_dpoly, got {poly.dtype}")
    m = _f32_on(mask, x, "mask")
    p = None if poly is None else _f32_on(poly, x, "poly")
    dx = torch.empty_like(x)
    stripes, per = bwd_stripes(rows)
    partial = dpoly = None
    if need_dpoly:
        partial = torch.empty((stripes, 3, cols), dtype=torch.float32,
                              device=x.device)
        dpoly = torch.empty((3, cols), dtype=poly.dtype, device=x.device)
    if x.numel() == 0:
        return dx, None if dpoly is None else dpoly.zero_()
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.masked_act_gate_bwd_launch(
            x.data_ptr(), m.data_ptr(), None if p is None else p.data_ptr(),
            g.data_ptr(), dx.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if dpoly is None else dpoly.data_ptr(), rows, cols, per,
            KIND_CODES[kind], _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[poly.dtype] if need_dpoly else 0, _stream(x))
    build.check(lib, code, name)
    build.count_launch(name)
    return dx, dpoly


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
    refuse_grad(name, x, mask, poly)
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


def conv_route(dtype, b: int, cin: int, cout: int, ptrs, h: int, w: int,
               n_cand: int) -> str:
    """The route of a fused gate→conv call on the card, by one rule.

    ``"tf32x3"`` (route T, ``csrc/masked_act_conv_sm90.cu``): float32, the
    batch B a multiple of 64 (one wgmma fragment of images), Cin and Cout
    multiples of 8 (TMA copies rows whose pitch is a multiple of 16 bytes,
    and the products run in 8-channel slices), every operand's address in
    ``ptrs`` (None is skipped) 16-byte aligned, and the TMA coordinates —
    ``h * w * cin`` along a row of x, ``n_cand * b`` rows — within a signed
    32-bit integer.  Stride 1 and 2 alike.  ``"fma"`` (route F,
    ``csrc/masked_act.cu``): every bfloat16 call, and every float32 call
    route T cannot take.  Raises TypeError for another dtype and ValueError
    for an empty batch, Cin or Cout, which no route takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused conv: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    if b < 1 or cin < 1 or cout < 1 or h < 1 or w < 1 or n_cand < 1:
        raise ValueError(f"fused conv: no route takes B={b}, Cin={cin}, "
                         f"Cout={cout}, H={h}, W={w}, n_cand={n_cand}")
    if (dtype == torch.float32 and b % 64 == 0 and cin % 8 == 0
            and cout % 8 == 0 and h * w * cin < _TMA_ROWS
            and n_cand * b < _TMA_ROWS
            and all(p % 16 == 0 for p in ptrs if p is not None)):
        return "tf32x3"
    return "fma"


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
    if cin == 0:
        return out.zero_()
    route = conv_route(x.dtype, b, cin, cout, (
        x.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr()),
        h, wd, n)
    # route T's big and small TF32 parts of w, K-major: (2, Cout, 9*Cin)
    scratch = torch.empty((2, cout, 9 * cin), dtype=torch.float32,
                          device=x.device) if route == "tf32x3" else None
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.masked_act_conv3x3_launch(
            x.data_ptr(), mask.data_ptr(), w.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            n, b, h, wd, cin, cout, ho, wo, stride, plo_h, plo_w,
            x_cand_stride, mask_cand_stride, KIND_CODES[kind], dtype,
            CONV_ROUTES[route], _stream(x))
    build.check(lib, code, f"{name} ({route} route)")
    build.count_launch(name, route)
    return out


def masked_act_conv3x3(x: torch.Tensor, mask: torch.Tensor,
                       w: torch.Tensor, *, stride: int = 1,
                       kind: str = "relu") -> torch.Tensor:
    """Fused gate + SAME 3x3 conv: x (B, H, W, Cin) contiguous, mask
    (H, W, Cin) — the full per-pixel site mask, shared over the batch — w
    HWIO (3, 3, Cin, Cout).  Returns (B, Ho, Wo, Cout) in x's dtype."""
    name = "masked_act_conv3x3"
    refuse_grad(name, x, mask, w)
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
    refuse_grad(name, x, mask, w)
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


def _cand_stride(name, what, t, n, per):
    """Candidate stride of an (N, rows, K) operand that is contiguous per
    candidate: ``per`` (stacked) or 0 (an ``expand``-ed shared tensor)."""
    if not t[0].is_contiguous() or not (n == 1 or t.stride(0) in (0, per)):
        raise ValueError(f"{name}: {what} must be contiguous per candidate "
                         f"with candidate stride {per} or 0, got strides "
                         f"{t.stride()}")
    return 0 if n == 1 else t.stride(0)


def matmul_route(dtype, k: int, n_out: int, rows: int, n_cand: int,
                 ptrs) -> str:
    """The route of a fused gate→matmul call on the card, by one rule.

    ``"wgmma"`` (route A, ``csrc/masked_act_matmul_sm90.cu``): bfloat16, K
    and N_out multiples of 8 (TMA copies rows whose pitch is a multiple of
    16 bytes), every operand's address in ``ptrs`` (x, mask, w, out and mul
    where given; None is skipped) 16-byte aligned, and the stacked rows
    ``n_cand * rows`` within a TMA coordinate.  ``"fma"`` (route B,
    ``csrc/masked_act_matmul.cu``): every float32 call, and every bfloat16
    call route A cannot take.  Raises TypeError for another dtype and
    ValueError for an empty K or N_out, which no route takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused matmul: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    if k < 1 or n_out < 1 or rows < 0 or n_cand < 1:
        raise ValueError(f"fused matmul: no route takes K={k}, "
                         f"N_out={n_out}, rows={rows}, n_cand={n_cand}")
    if (dtype == torch.bfloat16 and k % 8 == 0 and n_out % 8 == 0
            and n_cand * rows < _TMA_ROWS
            and all(p % 16 == 0 for p in ptrs if p is not None)):
        return "wgmma"
    return "fma"


def _launch_matmul(name, x, mask, w, mul, n, rows, k, x_stride, mul_stride,
                   mask_stride, kind, out):
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"{name}: w must be ({k}, N_out), "
                         f"got {tuple(w.shape)}")
    for what, t in (("w", w), ("mul", mul)):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError(f"{name}: {what} must share x's device and "
                             "dtype")
    w = w.contiguous()
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    route = matmul_route(x.dtype, k, w.shape[1], rows, n, (
        x.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if mul is None else mul.data_ptr()))
    lib = build.load()
    with torch.cuda.device(x.device):
        code = lib.masked_act_matmul_launch(
            x.data_ptr(), mask.data_ptr(),
            None if mul is None else mul.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, rows, k, w.shape[1], x_stride, mul_stride,
            mask_stride, KIND_CODES[kind], _DTYPE_CODES[x.dtype],
            MATMUL_ROUTES[route], _stream(x))
    build.check(lib, code, f"{name} ({route} route)")
    build.count_launch(name, route)
    return out


def masked_act_matmul_2d(x: torch.Tensor, mask: torch.Tensor,
                         w: torch.Tensor, mul: Optional[torch.Tensor] = None,
                         *, kind: str = "relu") -> torch.Tensor:
    """Fused ``(m·act(x) + (1−m)·x) [· mul] @ w``: x (rows, K) contiguous,
    mask (K,), w (K, N_out), mul optional (rows, K) contiguous, all but the
    mask in x's dtype.  Returns (rows, N_out) in x's dtype; the gated tensor
    is never written to device memory."""
    name = "masked_act_matmul_2d"
    refuse_grad(name, x, mask, w, mul)
    _check_common(name, x, kind)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (rows, K) tensor, "
                         f"got {tuple(x.shape)} {x.stride()}")
    rows, k = x.shape
    if mask.shape != (k,):
        raise ValueError(f"{name}: mask must be ({k},), "
                         f"got {tuple(mask.shape)}")
    if mul is not None and (mul.shape != x.shape or not mul.is_contiguous()):
        raise ValueError(f"{name}: mul must be a contiguous {tuple(x.shape)} "
                         f"tensor, got {tuple(mul.shape)} {mul.stride()}")
    out = torch.empty((rows, w.shape[-1]), dtype=x.dtype, device=x.device)
    return _launch_matmul(name, x, _f32_on(mask, x, "mask"), w, mul, 1, rows,
                          k, 0, 0, 0, kind, out)


def masked_act_matmul_2d_batched(x: torch.Tensor, mask: torch.Tensor,
                                 w: torch.Tensor,
                                 mul: Optional[torch.Tensor] = None, *,
                                 kind: str = "relu") -> torch.Tensor:
    """Stacked-candidate :func:`masked_act_matmul_2d`: x (N, rows, K) and
    mul (N, rows, K), each contiguous per candidate with candidate stride
    rows*K or 0 (an ``expand``-ed tensor the candidates share); mask (N, K),
    row b for candidate b; w shared.  Returns a fresh (N, rows, N_out)
    tensor."""
    name = "masked_act_matmul_2d_batched"
    refuse_grad(name, x, mask, w, mul)
    _check_common(name, x, kind)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (N, rows, K), "
                         f"got {tuple(x.shape)}")
    n, rows, k = x.shape
    if mask.shape != (n, k):
        raise ValueError(f"{name}: mask must be ({n}, {k}), "
                         f"got {tuple(mask.shape)}")
    xs = _cand_stride(name, "x", x, n, rows * k)
    us = 0
    if mul is not None:
        if mul.shape != x.shape:
            raise ValueError(f"{name}: mul must be {tuple(x.shape)}, "
                             f"got {tuple(mul.shape)}")
        us = _cand_stride(name, "mul", mul, n, rows * k)
    out = torch.empty((n, rows, w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    return _launch_matmul(name, x, _f32_on(mask, x, "mask"), w, mul, n, rows,
                          k, xs, us, k, kind, out)
