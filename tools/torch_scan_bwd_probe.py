#!/usr/bin/env python3
"""Where the RWKV-6 scan backward's time goes on one NVIDIA GPU.

    python3 tools/torch_scan_bwd_probe.py            # both parts
    python3 tools/torch_scan_bwd_probe.py --phases   # device time by phase
    python3 tools/torch_scan_bwd_probe.py --host     # the wrapper's host time

``--phases`` compiles copies of ``csrc/rwkv6_scan_bwd_sm90.cu`` with one
phase of ``rwkv6_scan_bwd_tf32x3_kernel`` left out each (their results are
wrong on purpose) into ``build/scan_bwd_probe/``, and times each, queued
behind a spin kernel, at the RWKV-6 3B path's stacked shape
``(1280, 128, 64, 64)`` and the family sweep's training shape
``(160, 32, 64, 64)``, from the chunks' states that route C of the forward
keeps.  The time a variant saves is what its phase costs in the whole.

``--host`` times the Python of the wrappers (``rwkv6_scan``,
``rwkv6_scan_bwd``) and of their parts at the training shape: host
microseconds a call, averaged over 300 calls.

Prints the card's name and power limit.  Needs nvcc and a card; reads
nothing but this checkout.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
from repro_torch.kernels import build, rwkv6_scan as RS  # noqa: E402

SRC = os.path.join(HERE, "src/repro_torch/kernels/csrc/"
                   "rwkv6_scan_bwd_sm90.cu")
OUT = os.path.join(HERE, "build", "scan_bwd_probe")
# each left-out phase: the statement that begins it, whose braces (and an
# else branch) end it
PHASES = {
    1: ("in-sub-block scores, cross scores, H",
        "    {\n      // inside sub-block sb"),
    2: ("M2 = dY S0^T, M1 = V dS^T",
        "#pragma unroll\n      for (int which = 0"),
    3: ("dv's dS_end term",
        "#pragma unroll\n      for (int j = 0; j < 8; ++j) {\n"
        "        // the accumulator"),
    4: ("the carry of dS",
        "#pragma unroll\n      for (int j = 0; j < 8; ++j) {\n"
        "        const float* b = rt"),
    5: ("the per-column recursions (dr, dk, dw)",
        "    if (fwd_role) {\n      const float gk"),
}
SHIM = r'''
extern "C" int probe_launch(const void* r, const void* k, const void* v,
    const void* w, const void* u, const void* dy, const void* states,
    void* du_row, void* dr, void* dk, void* dv, void* dw, int BH, int T,
    int K, int V, int u_rows, void* stream) {
  return rwkv6_scan_bwd_tf32x3_launch(r, k, v, w, u, dy, nullptr, states,
      du_row, dr, dk, dv, dw, nullptr, BH, T, K, V, u_rows,
      (cudaStream_t)stream);
}
'''


def _block_end(text, i):
    depth = 0
    while True:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1


def variant_source(text):
    """The source with each phase wrapped in ``if (PROBE != id)``."""
    for pid, (_, anchor) in PHASES.items():
        i = text.index(anchor)
        first = anchor.split("\n")[0]
        end = _block_end(text, text.index("{", i + (len(first)
                                                    if first.startswith("#")
                                                    else 0)))
        if text[end:].startswith(" else {"):
            end = _block_end(text, end + len(" else "))
        text = (text[:i] + f"if (PROBE != {pid}) {{\n" + text[i:end] +
                "\n}" + text[end:])
    return text + SHIM


def inputs(bh, T, H=40, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device="cuda") * 0.5
    r, k, v, dy = rn(bh, T, 64), rn(bh, T, 64), rn(bh, T, 64), rn(bh, T, 64)
    w = 0.7 + 0.299 * torch.rand((bh, T, 64), generator=g, device="cuda")
    u = rn(H, 64)
    state = torch.zeros((1, 64, 64), device="cuda").expand(bh, 64, 64)
    return r, k, v, w, u, state, dy


def queued_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phases():
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "variants.cu")
    with open(src, "w") as f:
        f.write(variant_source(open(SRC).read()))
    nvcc = build.find_nvcc()
    ids = [0] + list(PHASES)
    procs = {pid: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-shared", f"-DPROBE={pid}", "-o",
         os.path.join(OUT, f"v{pid}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in ids}
    libs = {}
    for pid, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc failed:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"v{pid}.so"))
        lib.probe_launch.restype = ctypes.c_int
        lib.probe_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        libs[pid] = lib
    for bh, T in ((1280, 128), (160, 32)):
        r, k, v, w, u, state, dy = inputs(bh, T)
        states = RS.rwkv6_scan(r, k, v, w, u, state, chunk=1,
                               keep_states=True)[2]
        dr, dk, dv, dw = (torch.empty((bh, T, 64), device="cuda")
                          for _ in range(4))
        du_row = torch.empty((bh, 64), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for pid in ids:
            def call(lib=libs[pid]):
                code = lib.probe_launch(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), dy.data_ptr(), states.data_ptr(),
                    du_row.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), dw.data_ptr(), bh, T, 64, 64, u.shape[0],
                    stream)
                if code:
                    sys.exit(f"launch failed: {code}")
            times[pid] = min(queued_ms(call) for _ in range(2))
        print(f"({bh}, {T}, 64, 64): whole {times[0]:.4f} ms queued",
              flush=True)
        for pid, t in times.items():
            if pid:
                print(f"    without {PHASES[pid][0]}: {t:.4f} ms (the "
                      f"phase: {times[0] - t:.4f})", flush=True)


def host():
    bh, T = 160, 32
    r, k, v, w, u, state, dy = inputs(bh, T)
    states = RS.rwkv6_scan(r, k, v, w, u, state, chunk=1,
                           keep_states=True)[2]
    dev = r.device

    def per_call(fn, n=300):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        return us

    def in_device():
        with torch.cuda.device(dev):
            pass
    parts = {
        "rwkv6_scan_bwd, from states": lambda: RS.rwkv6_scan_bwd(
            r, k, v, w, u, state, dy, need_ds0=False, states=states),
        "rwkv6_scan_bwd, alone": lambda: RS.rwkv6_scan_bwd(
            r, k, v, w, u, state, dy, need_ds0=False),
        "rwkv6_scan": lambda: RS.rwkv6_scan(r, k, v, w, u, state, chunk=32),
        "rwkv6_scan, keep_states": lambda: RS.rwkv6_scan(
            r, k, v, w, u, state, chunk=32, keep_states=True),
        "  _check": lambda: RS._check("probe", r, k, v, w, u, state, dy=dy,
                                      ds_end=None),
        "  _table_and_state": lambda: RS._table_and_state(u, state, bh),
        "  one torch.empty": lambda: torch.empty((bh, T, 64), device=dev),
        "  with torch.cuda.device": in_device,
        "  torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "  build.count_launch": lambda: build.count_launch(
            "rwkv6_scan_bwd", "tf32x3"),
    }
    for name, fn in parts.items():
        print(f"{name:32s} {per_call(fn):8.1f} us a call", flush=True)
    build.reset_launch_counts()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.load()
    both = not (args.phases or args.host)
    if args.phases or both:
        phases()
    if args.host or both:
        host()


if __name__ == "__main__":
    main()
