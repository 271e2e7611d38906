"""Builds the CUDA sources under ``csrc/`` into one shared library, loads
it with ``ctypes``, and keeps the one registry of kernel launches
(:data:`launch_counts`) that every wrapper adds to.

The library is built at first use, from the sources in this package and
nothing else, with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

One ``nvcc -c`` per source, all started together, then one link.  The output
goes to ``build/repro_torch_kernels/`` under the repository root (or under
``$REPRO_TORCH_BUILD_DIR``), named after a hash of the sources, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs when the
module is imported: a machine without ``nvcc`` can import every module of the
package and only fails when a CUDA tensor asks for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# kernel launches per wrapper since the last reset_launch_counts(); each
# wrapper adds one where it launches its kernel, and nowhere else
launch_counts = {
    "masked_act_2d": 0,
    "masked_act_2d_bwd": 0,
    "masked_act_2d_batched": 0,
    "masked_act_conv3x3": 0,
    "masked_act_conv3x3_batched": 0,
    "masked_act_matmul_2d": 0,
    "masked_act_matmul_2d_batched": 0,
    "rwkv6_scan": 0,
    "rwkv6_scan_bwd": 0,
}
# the fused matmul's, the fused conv's and the scan's launches by route
# (kernels.masked_act.matmul_route and conv_route,
# kernels.rwkv6_scan.scan_route), reset with launch_counts
route_counts = {
    **{f"{name}:{route}": 0
       for name in ("masked_act_matmul_2d", "masked_act_matmul_2d_batched")
       for route in ("fma", "wgmma")},
    **{f"{name}:{route}": 0
       for name in ("masked_act_conv3x3", "masked_act_conv3x3_batched")
       for route in ("fma", "tf32x3")},
    **{f"rwkv6_scan:{route}": 0 for route in ("serial", "tf32x3")}}


_count_lock = threading.Lock()


def count_launch(name: str, route: Optional[str] = None) -> None:
    """Add one launch of ``name`` (and of ``name:route``) to the counts.
    Wrappers call this where they launch their kernel.  Under a lock: a
    sweep's reporting thread launches kernels beside its descent, and
    ``+= 1`` from two threads can lose an update."""
    with _count_lock:
        launch_counts[name] += 1
        if route is not None:
            route_counts[f"{name}:{route}"] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        for k in route_counts:
            route_counts[k] = 0


class KernelBuildError(RuntimeError):
    """The CUDA sources could not be compiled or loaded."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if not (root / "pyproject.toml").exists():
        root = Path.cwd()
    return root / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA kernels are compiled at first use "
        "and a CUDA tensor cannot be served without them")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [out_dir / f"{tag}.{s.stem}.o" for s in srcs]
    # one compiler per source, all in flight at once
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = []
    failed = False
    for s, p in zip(srcs, procs):
        text, _ = p.communicate()
        logs.append(f"== {s.name} (exit {p.returncode})\n{text}")
        failed = failed or p.returncode != 0
    log = "\n".join(logs)
    (out_dir / f"{lib_path.stem}.log").write_text(log)
    if failed:
        raise KernelBuildError(f"nvcc failed:\n{log}")
    tmp = out_dir / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)     # atomic: a racing process sees all or none
    return lib_path


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed for the loaded library's build (empty
    when the library was reused from an earlier build that kept no log)."""
    p = build_dir() / f"librepro_torch_kernels_{_digest()}.log"
    return p.read_text() if p.exists() else ""


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.masked_act_gate_launch.restype = i
    lib.masked_act_gate_launch.argtypes = [
        vp, vp, vp, vp, ll, ll, ll, ll, i, i, vp]
    lib.masked_act_gate_bwd_launch.restype = i
    lib.masked_act_gate_bwd_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, i, vp]
    lib.masked_act_conv3x3_launch.restype = i
    lib.masked_act_conv3x3_launch.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, ll, ll, i, i, i,
        vp]
    lib.masked_act_matmul_launch.restype = i
    lib.masked_act_matmul_launch.argtypes = [
        vp, vp, vp, vp, vp, i, ll, i, i, ll, ll, ll, i, i, i, vp]
    lib.masked_act_rcp_check.restype = i
    lib.masked_act_rcp_check.argtypes = [vp, vp]
    lib.rwkv6_scan_launch.restype = i
    lib.rwkv6_scan_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ll, i, vp]
    lib.rwkv6_scan_bwd_launch.restype = i
    lib.rwkv6_scan_bwd_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i,
        i, i, i, i, ll, i, vp]
    lib.masked_act_error_string.restype = ctypes.c_char_p
    lib.masked_act_error_string.argtypes = [i]


def load() -> ctypes.CDLL:
    """The kernels' library: built on the first call, cached afterwards."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = build()
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise KernelBuildError(f"cannot load {path}: {e}") from e
                _declare(lib)
                _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        msg = lib.masked_act_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {code} "
            f"({msg.decode() if msg else 'unknown'})")
