"""Plain PyTorch versions of every kernel in this package.

Used by tensors that lie on the CPU, by the tests, and as the yardstick the
CUDA kernels are held against on the card.  Never used for a CUDA tensor on
the package's own paths.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp_min(x, 0.0)
    if kind == "gelu":
        # tanh approximation — what the kernel computes
        return 0.5 * x * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))
    if kind == "silu":
        return x * (1.0 / (1.0 + torch.exp(-x)))
    if kind == "sqrelu":
        r = torch.clamp_min(x, 0.0)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def masked_act_ref(x, mask, kind: str = "relu", poly=None):
    """y = mask * act(x) + (1-mask) * g(x).

    x:    (..., C) activations
    mask: broadcastable against x — (C,) per-channel, or a full site shape,
          or (N, 1, ..., C) for stacked candidates
    poly: None -> g(x) = x; (3, C...) -> g(x) = a*x^2 + b*x + c
    """
    act = _act(x, kind)
    if poly is None:
        lin = x
    else:
        a, b, c = poly[0].to(x.dtype), poly[1].to(x.dtype), \
            poly[2].to(x.dtype)
        lin = a * x * x + b * x + c
    m = mask.to(x.dtype)
    return m * act + (1.0 - m) * lin


def same_pads(size: int, stride: int, window: int = 3):
    """XLA SAME-padding geometry for one spatial dim: (out, lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    lo = total // 2
    return out, lo, total - lo


def conv_same_nhwc(x, w, stride: int = 1):
    """SAME convolution, x (B, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO.

    The NHWC tensor viewed as NCHW is exactly ``channels_last``, which
    ``F.conv2d`` takes without a copy.  SAME pads follow XLA: at stride 2 on
    an even size a 3-tap window pads (0, 1), which ``padding=1`` would get
    wrong.
    """
    kh, kw = w.shape[0], w.shape[1]
    _, hlo, hhi = same_pads(x.shape[1], stride, kh)
    _, wlo, whi = same_pads(x.shape[2], stride, kw)
    xn = x.permute(0, 3, 1, 2)
    if hlo == hhi and wlo == whi:
        padding = (hlo, wlo)
    else:
        xn = F.pad(xn, (wlo, whi, hlo, hhi))
        padding = 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def masked_act_conv3x3_ref(x, mask, w, *, stride: int = 1,
                           kind: str = "relu"):
    """The unfused pair: full-site gate, then the SAME 3x3 convolution.

    x: (B, H, W, Cin) or stacked (N, B, H, W, Cin); mask: (H, W, Cin) or
    stacked (N, H, W, Cin) (either side may be un-stacked: it is shared by
    the candidates); w: (3, 3, Cin, Cout).
    """
    m = mask.to(x.dtype)
    if m.dim() == 4:
        m = m[:, None]
    g = m * _act(x, kind) + (1.0 - m) * x
    lead = g.shape[:-3]
    y = conv_same_nhwc(g.reshape((-1,) + g.shape[-3:]), w, stride)
    return y.reshape(lead + y.shape[1:])
