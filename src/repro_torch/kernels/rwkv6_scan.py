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

:func:`rwkv6_scan_bwd` is the scan's gradient, which the reference does not
have as a kernel: ``kernels.ops.RWKV6ScanFn`` calls it, and it counts its
launches under ``"rwkv6_scan_bwd"`` and the route's entry.  It has two
routes too, picked by :func:`scan_bwd_route`: ``"tf32x3"``
(``csrc/rwkv6_scan_bwd_sm90.cu``: route C's form walked backward, chunks of
16 tokens last to first, the chunk products on the TF32 tensor cores as
big+small splits, no division by a decay) and ``"serial"``
(``csrc/rwkv6_scan_bwd.cu``: token by token from checkpoints every 8
tokens), kept as its yardstick.
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


def _check(name, r, k, v, w, u, state, chunk=1, **more):
    """The scan's checks on device, type and shapes, for the forward and
    the backward alike (``more``: the backward's dy and ds_end, None
    skipped).  Returns (BH, T, K, V)."""
    refuse_grad(name, r, k, v, w, u, state, *more.values())
    named = dict(r=r, k=k, v=v, w=w, u=u, state=state,
                 **{n: t for n, t in more.items() if t is not None})
    for what, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops, which uses "
                             "the plain version)")
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
    for what, want in (("dy", (bh, T, V)), ("ds_end", (bh, K, V))):
        t = more.get(what)
        if t is not None and t.shape != want:
            raise ValueError(f"{name}: {what} must be {want}, got "
                             f"{tuple(t.shape)}")
    if u.dim() != 2 or u.shape[1] != K or u.shape[0] < 1 or \
            bh % u.shape[0]:
        raise ValueError(f"{name}: u must be ({bh}, {K}) or (H, {K}) with "
                         f"H dividing {bh}, got {tuple(u.shape)}")
    if chunk < 1 or T % chunk:
        raise ValueError(f"{name}: T = {T} is not a multiple of chunk = "
                         f"{chunk}")
    scan_route(r.dtype, bh, T, K, V)
    return bh, T, K, V


def _table_and_state(u, state, bh):
    """u and the initial state as the kernels take them: a stride-0 expand
    of one row handed over as that one row.  Returns ``(u, s0,
    shared_state)``, shared_state when s0 is one row for every bh."""
    if bh > 1 and u.stride(0) == 0:
        u = u[:1]
    shared_state = bh > 1 and state.stride(0) == 0
    s0 = (state[:1] if shared_state else state).contiguous()
    return u.contiguous(), s0, shared_state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int = 32, keep_states: bool = False):
    """The RWKV-6 recurrence over (BH, T, ·) CUDA tensors, float32 only.

    r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K) — its rows may be a
    stride-0 expand — or an (H, K) per-head table with H dividing BH (row
    bh reads ``u[bh % H]``); state: (BH, K, V), whose rows may be a stride-0
    expand of one shared state.  K and V at most 64.  ``chunk`` is the
    reference's: T must be a multiple of it, though the kernels chunk by
    their own rule (route C: 16 tokens; route S: token by token).  Returns
    y (BH, T, V) and the new state (BH, K, V).  ``keep_states`` (the scan
    under autograd): returns the state entering each chunk of 16 tokens as
    well, the flat (BH, ceil(T / 16), V, K) tiles that route C writes for
    :func:`rwkv6_scan_bwd`, or None on route S, which keeps none.
    """
    name = "rwkv6_scan"
    bh, T, K, V = _check(name, r, k, v, w, u, state, chunk=chunk)
    route = scan_route(r.dtype, bh, T, K, V)
    u, s0, shared_state = _table_and_state(u, state, bh)
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    y = torch.empty((bh, T, V), dtype=torch.float32, device=r.device)
    s_out = torch.empty((bh, K, V), dtype=torch.float32, device=r.device)
    states = _states(bh, T, r.device) \
        if keep_states and route == "tf32x3" else None
    if bh > 0:
        lib = build.load()
        with torch.cuda.device(r.device):
            code = lib.rwkv6_scan_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                None if states is None else states.data_ptr(),
                bh, T, K, V, u.shape[0], 0 if shared_state else K * V,
                SCAN_ROUTES[route],
                torch.cuda.current_stream(r.device).cuda_stream)
        build.check(lib, code, f"{name} ({route} route)")
        build.count_launch(name, route)
    return (y, s_out, states) if keep_states else (y, s_out)


SCAN_BWD_ROUTES = {"serial": 0, "tf32x3": 1}
# tokens between two of the states the backward reads, by route
# (``csrc/rwkv6_scan_bwd.cu`` kCk: a checkpoint every 8 tokens;
# ``csrc/rwkv6_scan_bwd_sm90.cu`` kC: the state entering each chunk of 16),
# and the width their tiles pad K and V to
BWD_CHUNK = {"serial": 8, "tf32x3": 16}
BWD_PAD = 64


def _states(bh: int, T: int, device) -> torch.Tensor:
    """Room for the state entering each chunk of 16 tokens, a 64 x 64 tile
    (v, k) each, as route C writes them and route ``"tf32x3"`` of the
    backward reads them."""
    n = -(-T // BWD_CHUNK["tf32x3"])
    return torch.empty((bh * n * BWD_PAD * BWD_PAD,), dtype=torch.float32,
                       device=device)


def scan_bwd_route(dtype, bh: int, T: int, K: int, V: int) -> str:
    """The route of a backward call on the card, by the rule of
    :func:`scan_route`: ``"tf32x3"`` takes every float32 call with K and V
    in [1, MAX_WIDTH], any number of rows and any T (a last partial chunk
    and K, V below 64 are zero-padded on chip); ``"serial"`` takes the same
    calls and is kept beside it as its yardstick.  Raises TypeError for
    another dtype and ValueError for what no route takes."""
    if dtype != torch.float32:
        raise TypeError(f"rwkv6_scan_bwd: dtype must be float32, got {dtype}")
    if bh < 0 or T < 0 or not (1 <= K <= MAX_WIDTH and 1 <= V <= MAX_WIDTH):
        raise ValueError(f"rwkv6_scan_bwd: no route takes BH = {bh}, "
                         f"T = {T}, K = {K}, V = {V} (K and V must lie in "
                         f"[1, {MAX_WIDTH}])")
    return "tf32x3"


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   dy: torch.Tensor, ds_end=None, *, need_ds0: bool = True,
                   states=None):
    """The gradient of :func:`rwkv6_scan` over (BH, T, ·) CUDA tensors,
    float32 only, on the route :func:`scan_bwd_route` picks
    (``rwkv6_scan_bwd_tf32x3_kernel`` or ``rwkv6_scan_bwd_kernel``, and
    ``rwkv6_du_reduce_kernel`` for an (H, K) table).

    Inputs as :func:`rwkv6_scan` (any T), plus dy (BH, T, V), the gradient
    of y, and ``ds_end`` (BH, K, V) or None, that of the final state.
    ``states``: what ``rwkv6_scan(keep_states=True)`` returned for the same
    inputs, the state entering each chunk, which route ``"tf32x3"`` reads;
    without it that route runs :func:`rwkv6_scan` first to get them (route
    ``"serial"`` recomputes its own checkpoints whatever it is given).
    Returns ``(dr, dk, dv, dw, du, ds0)``: du in u's own shape — an (H, K)
    table's rows summed over the rows of each head, in a fixed order — and
    ds0 (BH, K, V), or None without ``need_ds0``.  The plain version is
    ``ref.rwkv6_scan_bwd_ref``."""
    name = "rwkv6_scan_bwd"
    bh, T, K, V = _check(name, r, k, v, w, u, state, dy=dy, ds_end=ds_end)
    route = scan_bwd_route(r.dtype, bh, T, K, V)
    du_rows = u.shape[0]
    u_k, s0, shared_state = _table_and_state(u, state, bh)
    r, k, v, w, dy = (t.contiguous() for t in (r, k, v, w, dy))
    dse = None if ds_end is None else ds_end.contiguous()
    dev = r.device
    dr, dk, dw = (torch.empty((bh, T, K), dtype=torch.float32, device=dev)
                  for _ in range(3))
    dv = torch.empty((bh, T, V), dtype=torch.float32, device=dev)
    du = torch.empty((du_rows, K), dtype=torch.float32, device=dev)
    ds0 = torch.empty((bh, K, V), dtype=torch.float32, device=dev) \
        if need_ds0 else None
    if bh == 0:
        return dr, dk, dv, dw, du, ds0
    n_ck = -(-T // BWD_CHUNK[route])
    if route == "serial":
        ck = torch.empty((bh * n_ck * BWD_PAD * BWD_PAD,),
                         dtype=torch.float32, device=dev)
    elif states is None:
        ck = rwkv6_scan(r, k, v, w, u, state, chunk=1, keep_states=True)[2]
        if ck is None:
            raise RuntimeError(f"{name}: the forward's route keeps no "
                               "chunk states for route tf32x3")
    else:
        want = bh * n_ck * BWD_PAD * BWD_PAD
        if states.dtype != torch.float32 or states.device != dev or \
                states.numel() != want or not states.is_contiguous():
            raise ValueError(f"{name}: states must be {want} contiguous "
                             f"float32 on {dev} (rwkv6_scan(keep_states="
                             f"True) of the same inputs), got "
                             f"{tuple(states.shape)} {states.dtype} on "
                             f"{states.device}")
        ck = states
    du_row = du if du_rows == bh else \
        torch.empty((bh, K), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        code = lib.rwkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u_k.data_ptr(), s0.data_ptr(), dy.data_ptr(),
            None if dse is None else dse.data_ptr(), ck.data_ptr(),
            du_row.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dw.data_ptr(), du.data_ptr(),
            None if ds0 is None else ds0.data_ptr(), bh, T, K, V,
            u_k.shape[0], 0 if shared_state else K * V, du_rows,
            SCAN_BWD_ROUTES[route],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, f"{name} ({route} route)")
    build.count_launch(name, route)
    return dr, dk, dv, dw, du, ds0
