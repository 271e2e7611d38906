"""Wrapper of the hand-written RWKV-6 scan kernels.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  The scan has two routes,
picked by :func:`scan_route`: ``"tf32x3"`` (route C,
``csrc/rwkv6_scan_sm90.cu``: chunks of 16 tokens, the products on the TF32
tensor cores with each float32 operand split into a big and a small part,
no division by a decay product) and ``"serial"`` (route S,
``csrc/rwkv6_scan.cu``: token by token on the CUDA cores).  The wrapper
checks device, type and shapes, allocates its outputs with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to ``build.launch_counts["rwkv6_scan"]`` and to the route's
``build.route_counts`` entry (``build.count_launch``) — there and nowhere
else.  A route that cannot
take a call raises; nothing falls back to the other route or to the plain
version.  It takes CUDA tensors only; CPU tensors are served by
``kernels.ops.rwkv6`` through the plain version
``kernels.ref.rwkv6_scan_ref``.
"""
from __future__ import annotations

import torch

from . import build
from .masked_act import refuse_grad

# K and V at most: route S keeps one value column's S[:, v] in a thread's
# registers, route C pads K and V to 64 on chip
MAX_WIDTH = 64
SCAN_ROUTES = {"serial": 0, "tf32x3": 1}


def scan_route(dtype, bh: int, T: int, K: int, V: int) -> str:
    """The route of a scan call on the card, by one rule.

    ``"tf32x3"`` (route C) takes every float32 call with K and V in
    [1, MAX_WIDTH], any number of rows and any T (a last partial chunk and
    K, V below 64 are zero-padded on chip, with 16-byte copies where K and V
    are multiples of 4 and the rows 16-byte aligned, else 4-byte ones), so
    the rule sends every call to it; ``"serial"`` (route S) takes the same
    calls and is kept beside it as its yardstick.  Raises TypeError for
    another dtype and ValueError for what no route takes."""
    if dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: dtype must be float32, got {dtype}")
    if bh < 0 or T < 0 or not (1 <= K <= MAX_WIDTH and 1 <= V <= MAX_WIDTH):
        raise ValueError(f"rwkv6_scan: no route takes BH = {bh}, T = {T}, "
                         f"K = {K}, V = {V} (K and V must lie in "
                         f"[1, {MAX_WIDTH}])")
    return "tf32x3"


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int = 32):
    """The RWKV-6 recurrence over (BH, T, ·) CUDA tensors, float32 only.

    r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K) — its rows may be a
    stride-0 expand — or an (H, K) per-head table with H dividing BH (row
    bh reads ``u[bh % H]``); state: (BH, K, V), whose rows may be a stride-0
    expand of one shared state.  K and V at most 64.  ``chunk`` is the
    reference's: T must be a multiple of it, though the kernels chunk by
    their own rule (route C: 16 tokens; route S: token by token).  Returns
    y (BH, T, V) and the new state (BH, K, V).
    """
    name = "rwkv6_scan"
    refuse_grad(name, r, k, v, w, u, state)
    for what, t in dict(r=r, k=k, v=v, w=w, u=u, state=state).items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops, which uses "
                             "the plain version)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name}: {what} lies on {t.device}, r on "
                             f"{r.device}")
    if r.dim() != 3:
        raise ValueError(f"{name}: r must be (BH, T, K), got "
                         f"{tuple(r.shape)}")
    bh, T, K = r.shape
    V = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or \
            v.shape != (bh, T, V) or state.shape != (bh, K, V):
        raise ValueError(
            f"{name}: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} w {tuple(w.shape)} state "
            f"{tuple(state.shape)} do not fit (BH, T, K), (BH, T, V), "
            "(BH, K, V)")
    if u.dim() != 2 or u.shape[1] != K or u.shape[0] < 1 or \
            bh % u.shape[0]:
        raise ValueError(f"{name}: u must be ({bh}, {K}) or (H, {K}) with "
                         f"H dividing {bh}, got {tuple(u.shape)}")
    if chunk < 1 or T % chunk:
        raise ValueError(f"{name}: T = {T} is not a multiple of chunk = "
                         f"{chunk}")
    route = scan_route(r.dtype, bh, T, K, V)
    # a stride-0 expand of one row is handed over as that one row
    if bh > 1 and u.stride(0) == 0:
        u = u[:1]
    u = u.contiguous()
    shared_state = bh > 1 and state.stride(0) == 0
    s0 = (state[:1] if shared_state else state).contiguous()
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    y = torch.empty((bh, T, V), dtype=torch.float32, device=r.device)
    s_out = torch.empty((bh, K, V), dtype=torch.float32, device=r.device)
    if bh == 0:
        return y, s_out
    lib = build.load()
    with torch.cuda.device(r.device):
        code = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            bh, T, K, V, u.shape[0], 0 if shared_state else K * V,
            SCAN_ROUTES[route],
            torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, code, f"{name} ({route} route)")
    build.count_launch(name, route)
    return y, s_out
