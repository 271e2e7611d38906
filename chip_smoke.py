#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, and drives the port's five
paths, BCD candidate evaluation through ``bcd.run_bcd`` with the
sequential, batched, pipelined and suffix engines:

  1. masked-ReLU ResNet18 at full CIFAR width (``forward``, ``bcd``,
     ``sited`` lines);
  2. StableLM-2-1.6B at its published widths, float32, random weights, on
     eval tokens that the full-mask model continues greedily from a Markov
     prompt (``lm_batch``, ``lm_forward``, ``lm_bcd``, ``lm_sited`` lines);
  3. RWKV-6 3B the same way (``rwkv_batch``, ``rwkv_forward``, ``rwkv_bcd``,
     ``rwkv_sited`` lines), its time-mix scan on the ``rwkv6_scan`` kernel
     (route C, on the tensor cores), its channel-mix gate on the gate
     kernels; no fused route;
  4. DeepSeek-MoE-16B the same way, float32, every one of its 28 layers
     on the card (``moe_batch``, ``moe_forward``, ``moe_bcd``,
     ``moe_sited``, ``moe_serve`` lines): a dense head block and 27 MoE
     blocks of 64 routed experts (top-6) and a shared expert; the routed
     experts' gate on kernels 1/2, the dense head block and the shared
     experts fused (kernels 3/4, route B) under ``fused=``;
     ``moe_forward`` counts the (token, k) routes that differ between
     evaluation paths, profiles a forward and reports the card's peak
     memory;
  5. Zamba2-2.7B the same way (``hybrid_*`` lines): 9 repeats of five
     Mamba2 blocks (gate on kernels 1/2, the scan in plain PyTorch, as
     the reference's is jnp code) and one shared attention block; each
     Mamba2 output projection drawn at 1/32 of the init's scale, as
     RWKV-6's is, for the same reason.

Paths 4 and 5 also serve (``<tag>_serve``): ``launch.serve.generate`` of
2 x 16 prompt tokens by 8, each served token held to the uncached
argmax, and the decode step timed.

and, on path 1's model, the paper's training half (``train``, ``snl``,
``pipeline`` lines): the train step's gradients on the card against the
CPU's, its time with and without deterministic algorithms, then train →
SNL → finetune → BCD with finetuning between steps through the batched and
suffix engines, at ResNet18's full width with the schedule cut short.  The
hard gate's gradient runs on ``gate_bwd_kernel`` (``masked_act_2d_bwd``),
the one kernel of the port with no TPU counterpart.  Then the resumable
budget sweep (``sweep`` line, ``--only-sweep`` alone): the example's
``--sweep`` mode at ResNet18's full width on the suffix engine, serially
and overlapped in this process, SIGKILLed mid-stage in a child process and
resumed by another, and as two ranks on the one card; every run must give
the same stages and the same final parameter bits, and every checkpoint
save, deep validation and restore is timed; then, read apart, one serial
sweep of the schedule the example documents, at its own block size.
Then serving (``serve`` line, ``--only-serve`` alone): StableLM-2-1.6B at
full width, float32, through ``launch.serve_loop.ServeLoop`` — two
synthetic budgets, 4 slots of 128 tokens, 16 requests of 4-100 tokens
bucketed to 16, 16 new tokens each, a B=1 prefill per request copied into
a slot and ragged decode of every live slot; RWKV-6 3B at full width
through ``launch.serve.generate`` (a batched prefill of 4 x 20 tokens on
the scan kernel from the cache's state, then greedy decode on the exact
recurrence) and an exact-length ``ServeLoop``; every served token and its
logits held against the uncached forward; one decode tick timed and
profiled; and the reduced chaos drill (virtual clock, chaos plan, queue
bound, ladder, deadlines) on the card and on the CPU, whose decision
fingerprints, tokens and bills must be equal.

Each path runs with the launch counts set to 0 just before it and read just
after; the script checks that each went through its kernels and that the
engines select identical blocks.

Output: one JSON object per line (``env``, ``build``, ``kernel_cases``, the
path lines above), then the card's name and power limit as ``nvidia-smi``
prints them, then the ``kernels`` summary, then the result line.  Exits
non-zero, without a result line, if there is no CUDA device, if the build
fails, if a kernel misses its tolerance, or if any phase fails.  There is no
CPU path here.

Tolerances (stated again in the output):
  * gate, float32: |err| <= 1e-6 + 1e-6*|ref| — same arithmetic, rounded the
    same way; only tanhf/expf may differ from PyTorch's by an ulp.
  * gate backward, float32: dx |err| <= 1e-6 + 1e-6*|ref|, as the gate;
    dpoly, a sum over r rows in another order than the plain version's,
    |err| <= 1e-7 + 2*(r - 1)*2^-24*sum|terms|, the bound of two float32
    sums of r terms; and a second launch gives the same bits.
  * train step, through gate_bwd_kernel vs through the plain backward,
    both on the card: each leaf's gradient within 1e-6 of its largest
    entry (the kernel's dx is the plain version's to the bit in every
    case; cuDNN runs its deterministic algorithms).
  * train step, card vs CPU: each leaf's relative L2 error
    |g_card - g_cpu| / |g_cpu| <= 2e-3 — the forward's 2e-3 on O(1)
    logits, carried to each leaf's norm.  Not each entry: the gradient is
    discontinuous at a ReLU whose input lies within rounding of 0, and
    among 17.8 million gate inputs a few take the other sign on the other
    device (counted and printed); each moves single entries downstream of
    it by up to one product's worth (0.5 % of a leaf's largest entry
    seen), the leaf's norm far less.
  * gate and fused conv, bfloat16: |err| <= 1e-2 + 1e-2*|ref| against the
    plain version computed in float32 from the same bfloat16 inputs and
    rounded once — one bfloat16 ulp is 2^-8 relative.
  * fused conv, float32: |err| <= 2e-4 + 2e-4*|ref| — up to 9*512 products
    are summed in another order than cuDNN's full-float32 algorithms
    (TF32 is off), some of which (Winograd, FFT) round more than a direct
    sum.  Route T (``tf32x3``) takes each product as three TF32 products
    of split operands; at ResNet18's batch its error against a float64
    convolution must stay within 4x the plain version's (TF32 products
    alone keep 11 significant bits), and route F, forced beside it, is
    held to the same tolerance.
  * fused matmul, float32 (route B, ``fma``): |err| <= 2e-4 + 2e-4*|ref| —
    a 5632-term sum in another order than cuBLAS's, each term a gated
    product rounded on its own; the error of both against a float64 product
    is printed too.  bfloat16 (route A, ``wgmma``, where the shape allows,
    else route B): the kernel rounds the gate, and its product with mul, to
    bfloat16 as the reference does, and sums in float32; it is held at the
    bfloat16 tolerance to the plain version run in bfloat16 on the same
    tensors (each elementwise step rounded to bfloat16, as the reference's
    kernel rounds), and to the unfused route on the card (gate kernel,
    ``* mul``, ``torch.matmul`` in bfloat16), which feeds the product the
    same bfloat16 operands, so only the order of the sum differs.  Every
    bfloat16 case at an LM shape must take route A.
  * ResNet logits: 2e-3 absolute between fused/unfused and
    stacked/un-stacked forwards, and between the card and the CPU —
    BatchNorm's rsqrt amplifies conv rounding through 17 gated layers.
  * RWKV-6 scan, float32: |err| <= 3e-4 + 3e-4*|ref|, the reference's own
    tolerance — the plain version is the chunked form, which divides by
    in-chunk decay products.  Every case takes the route the rule picks
    (route C, ``tf32x3``: the tensor cores, each operand split into TF32
    parts) and keeps its error against the token-serial recurrence in
    float64 within 4x the plain version's; route S (``serial``), forced
    beside it at the path's shapes, is held to the same tolerance.  Under
    strong decay (w down to 2e-9) the plain version is not finite, and
    route C must be finite with its error against float64 within 4x route
    S's.
  * LM logits: 1e-3 absolute, the same comparisons — 24 to 54 layers of
    sums of up to 10944 products in other orders; logits are O(1) and a
    float32 sum of that length is off by about 1e-5 relative.  The
    card-vs-CPU check runs the first 8 of RWKV-6's 32 repeats, DeepSeek's
    head block and first MoE repeat, and Zamba2's first 2 repeats.  A
    MoE token whose router top-6 is tied within rounding can route to
    another expert on another evaluation path, and the logits from it on
    are another function: on a MoE model each comparison holds the
    logits to 1e-3 at every position before the first token its two
    forwards routed differently, counts the positions from it on with
    their largest difference, and fails unless at least half the
    positions are held.
  * Served logits, cached vs uncached (the logits each prefill and decode
    tick kept, against the uncached forward of the prompt and the tokens
    before them): 1e-3 absolute, the LM tolerance — the same network with
    its products taken over other row counts (cuBLAS picks other kernels
    for 4 rows than for 100) and, on RWKV-6, the decode step's plain
    recurrence in place of the scan kernel.  Each served token must be the
    uncached argmax wherever the uncached top-2 margin exceeds 2e-3, twice
    the tolerance (two logits each off by at most 1e-3 cannot swap); where
    it does not, the token is counted, not judged.  On the MoE and
    hybrid paths the served tokens are judged so; their logits are
    reported, not held.  A MoE decode step has one slot an expert and
    drops nothing, while the uncached forward of a longer sequence may
    drop a generated token's pair at capacity (the reference's rule): the
    positions from such a drop on are another function of the tokens and
    are counted, not judged.  The chaos drill's decisions, tokens and
    bills: equal on the card and the CPU, exactly.

Times are CUDA-event times over repeated launches after a warm-up, at the
shapes the main path uses, without flushing the L2 cache between launches
(the big shapes exceed it).  ``bound_ms`` is the larger of bytes/3.35 TB/s
(each input read once, each output written once) and operations/67 TFLOP/s
(float32 outside the tensor cores) — for the fused matmul in bfloat16
operations/989 TFLOP/s, the tensor cores' rate, and for the fused conv on
route T 3 * operations/495 TFLOP/s, three TF32 products per float32 one
(``bound_fma_ms`` and ``bound_tf32x3_ms`` give both for every conv case);
the least time the card could take for that work.  The scan's operations
are 5·K·V a token and row (r·S, the state update) plus the bonus.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bfloat16 tensor cores, dense
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense

_CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {
    "masked_act_2d": _CSRC + "masked_act.cu",
    "masked_act_2d_bwd": _CSRC + "masked_act.cu",
    "masked_act_2d_batched": _CSRC + "masked_act.cu",
    "masked_act_conv3x3": _CSRC + "masked_act_conv_sm90.cu",
    "masked_act_conv3x3_batched": _CSRC + "masked_act_conv_sm90.cu",
    "masked_act_matmul_2d": _CSRC + "masked_act_matmul.cu",
    "masked_act_matmul_2d_batched": _CSRC + "masked_act_matmul.cu",
    # the fused matmul's routes (kernels.masked_act.matmul_route)
    "fma": _CSRC + "masked_act_matmul.cu",
    "wgmma": _CSRC + "masked_act_matmul_sm90.cu",
    "rwkv6_scan": _CSRC + "rwkv6_scan_sm90.cu",
    "rwkv6_scan_bwd": _CSRC + "rwkv6_scan_bwd.cu",
}
# the fused conv's routes (kernels.masked_act.conv_route)
CONV_SOURCE = {"tf32x3": _CSRC + "masked_act_conv_sm90.cu",
               "fma": _CSRC + "masked_act.cu"}
# the scan's routes (kernels.rwkv6_scan.scan_route)
SCAN_SOURCE = {"tf32x3": _CSRC + "rwkv6_scan_sm90.cu",
               "serial": _CSRC + "rwkv6_scan.cu"}
REPLACES = {
    "masked_act_2d": "src/repro/kernels/masked_act.py:55",
    # port-only: the gradient of kernel 1, which the reference takes by
    # autodiff of the plain gate (no backward pallas_call exists)
    "masked_act_2d_bwd": "src/repro/kernels/masked_act.py:55",
    "masked_act_2d_batched": "src/repro/kernels/masked_act.py:140",
    "masked_act_conv3x3": "src/repro/kernels/masked_act.py:393",
    "masked_act_conv3x3_batched": "src/repro/kernels/masked_act.py:424",
    "masked_act_matmul_2d": "src/repro/kernels/masked_act.py:235",
    "masked_act_matmul_2d_batched": "src/repro/kernels/masked_act.py:299",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:69",
    # port-only: the gradient of kernel 7, which the reference takes by
    # autodiff of its jnp scan (no backward pallas_call exists)
    "rwkv6_scan_bwd": "src/repro/kernels/rwkv6_scan.py:69",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "resnet18": ("masked_act_2d", "masked_act_2d_batched",
                 "masked_act_conv3x3", "masked_act_conv3x3_batched"),
    "stablelm_1p6b": ("masked_act_2d", "masked_act_2d_batched",
                      "masked_act_matmul_2d",
                      "masked_act_matmul_2d_batched"),
    "rwkv6_3b": ("masked_act_2d", "masked_act_2d_batched", "rwkv6_scan"),
    "deepseek_moe_16b": ("masked_act_2d", "masked_act_2d_batched",
                         "masked_act_matmul_2d",
                         "masked_act_matmul_2d_batched"),
    "zamba2_2p7b": ("masked_act_2d", "masked_act_2d_batched"),
    "resnet18_train": ("masked_act_2d", "masked_act_2d_bwd"),
    "resnet18_sweep": ("masked_act_2d", "masked_act_2d_batched",
                       "masked_act_conv3x3_batched", "masked_act_2d_bwd"),
    "serve": ("masked_act_2d", "rwkv6_scan"),
    # DeepSeek's fused suffix forwards add kernel 4 (no un-stacked fused
    # forward runs on this path: training and the batched engine are
    # unfused)
    "family_sweep": ("masked_act_2d", "masked_act_2d_bwd",
                     "masked_act_2d_batched", "rwkv6_scan",
                     "rwkv6_scan_bwd", "masked_act_matmul_2d_batched"),
}
# kernels with no TPU counterpart
PORT_ONLY = {"masked_act_2d_bwd": "the gradient of kernel 1 (the reference "
             "has no backward pallas_call; JAX differentiates the plain "
             "gate)",
             "rwkv6_scan_bwd": "the gradient of kernel 7 (the reference has "
             "no backward pallas_call; JAX differentiates its jnp "
             "linattn_chunked)"}
# ... and the routes (build.route_counts): ResNet18's float32 convs on
# route T (tensor cores); StableLM's float32 path on route B, its bfloat16
# forward on route A; RWKV-6's scans on route C (tensor cores), every one;
# DeepSeek-MoE's float32 dense head block and shared experts on route B
PATH_ROUTES = {
    "resnet18": ("masked_act_conv3x3:tf32x3",
                 "masked_act_conv3x3_batched:tf32x3"),
    "stablelm_1p6b": ("masked_act_matmul_2d:fma", "masked_act_matmul_2d:wgmma",
                      "masked_act_matmul_2d_batched:fma"),
    "rwkv6_3b": ("rwkv6_scan:tf32x3",),
    "deepseek_moe_16b": ("masked_act_matmul_2d:fma",
                         "masked_act_matmul_2d_batched:fma"),
    "resnet18_sweep": ("masked_act_conv3x3_batched:tf32x3",),
    "serve": ("rwkv6_scan:tf32x3",),
    "family_sweep": ("rwkv6_scan:tf32x3",
                     "masked_act_matmul_2d_batched:fma"),
}
# (rows, K, N_out) of the LM paths' fused products: every bfloat16 case at
# one of these must take route A
LM_MATMUL_SHAPES = {(1016, 5632, 2048)}
# ResNet18's eval batch and its four stages (H = W, C): every float32 conv
# case at this batch must take route T and keep its error against a float64
# convolution within CONV_ERR_RATIO times the plain version's
RESNET_BATCH = 128
STAGES = ((32, 64), (16, 128), (8, 256), (4, 512))
CONV_ERR_RATIO = 4.0
# every scan case on route C keeps its error against the float64 token loop
# within this many times the plain version's (under strong decay, where the
# plain version is not finite, route S's)
SCAN_ERR_RATIO = 4.0
TOL = {
    ("gate", torch.float32): (1e-6, 1e-6),
    ("gate", torch.bfloat16): (1e-2, 1e-2),
    ("gate_bwd", torch.float32): (1e-6, 1e-6),
    ("conv", torch.float32): (2e-4, 2e-4),
    ("conv", torch.bfloat16): (1e-2, 1e-2),
    ("matmul", torch.float32): (2e-4, 2e-4),
    ("matmul", torch.bfloat16): (1e-2, 1e-2),
    ("scan", torch.float32): (3e-4, 3e-4),
}
# the scan's backward against its plain version, each of dr, dk, dv, dw, du
# and ds0 elementwise: |kernel - plain| <= SCAN_BWD_ATOL * max|plain| (that
# gradient's scale) + SCAN_BWD_RTOL * |plain|; and each one's largest error
# against the float64 plain backward within SCAN_ERR_RATIO times the
# float32 plain version's
SCAN_BWD_ATOL, SCAN_BWD_RTOL = 1e-5, 1e-5
LOGIT_TOL = 2e-3
SEED = 0            # weights, data and masks
LM_BATCH = 8                # eval sequences on the LM paths
LM_PROMPT = 16              # Markov tokens before the greedy continuation
LM_CHUNK = 4                # candidates per chunk on the LM path
LM_STEPS = 2                # BCD outer steps per engine on the LM path
LM_DRC = 256                # nonlinearities removed per BCD step
LM_SITED_DRC = 32
LM_LOGIT_TOL = 1e-3
LM_CPU_TOKENS = 32          # the card-vs-CPU check: 1 sequence x 32 tokens
BCD_STEPS = 3       # outer steps per engine (b_target 300 below the start)
# the training half on ResNet18 (cuts of the schedule, not of the model)
TRAIN_BATCH = 32
TRAIN_STEPS = 20            # train_base (the example: 80)
SNL_EPOCHS, SNL_STEPS = 2, 5  # (the example: 6 x 5)
FT_STEPS = 5                # SNL's finetune and BCD's (the example: 15, 12)
TRAIN_BCD_STEPS = 2         # BCD outer steps per engine
TRAIN_TIMED = 10            # train steps per timing
KERNEL_STEP_TOL = 1e-6      # a step's gradients, gate_bwd_kernel vs plain
GRAD_TOL = 2e-3             # card vs CPU: each leaf's relative L2 error
# the resumable sweep on ResNet18 (the example's --sweep mode): B_ref = 0.6
# of 557,056 ReLUs = 334,233, then 334,230 and 334,227, so the example's
# drc, max(1, (B_ref - B_last) // 10), is 1: 3 accepted blocks a stage,
# each candidate touching one coordinate, so candidates cut deep enough for
# the suffix engine's fused route (kernel 6)
SWEEP_FLAGS = ("--full", "--engine", "suffix", "--ref-frac", "0.6")
SWEEP_SCHEDULE = "0.599994,0.599989"
# ... and, read once and checked for nothing but completion, the schedule
# the example documents: drc 11,141, stages of 3 and 8 blocks, candidates
# that touch the first sites (the suffix engine's unfused fallback)
SWEEP_DEFAULT_SCHEDULE = "0.55,0.4"
SWEEP_CHILD_TIMEOUT_S = 300
SWEEP_TIMED = 3             # timed repeats of a deep validation / restore
# serving: StableLM-2-1.6B's continuous-batching loop (two synthetic
# budgets, 4 slots of 128 tokens, prompts of 4-100 tokens bucketed to 16,
# 16 new tokens each) and RWKV-6 3B's batched prefill + decode (batch 4,
# prompt 20, 12 tokens: every length stays <= 32, which the reference's
# chunk rule accepts) and exact-length loop (prompts the rule accepts)
SERVE_SLOTS, SERVE_MAX_LEN = 4, 128
SERVE_REQUESTS, SERVE_MAX_NEW = 16, 16
SERVE_FRACS = (1.0, 0.25)
SERVE_MARGIN = 2 * LM_LOGIT_TOL   # a served token must be the argmax there
SERVE_PREFILL_LENS = (16, 48, 112)
SERVE_TICK_CACHE_LENS = (40, 64, 88, 112)
SERVE_TIMED_TICKS = 10
RWKV_SERVE_BATCH, RWKV_SERVE_PROMPT, RWKV_SERVE_GEN = 4, 20, 12
RWKV_LOOP_PROMPTS, RWKV_LOOP_MAX_LEN = (7, 20, 32, 64), 72
# the family sweep (examples/torch_family_bcd_sweep.py): its batch of
# sequences of its sequence length, as the reference's CI runs it
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 32


def counts() -> dict:
    """Every kernel's launches and the fused matmul's by route, as they
    stand."""
    from repro_torch.kernels import build
    return {**build.launch_counts, **build.route_counts}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Device time of ``fn`` without the host's share: the launches are
    queued behind a spin kernel (``torch.cuda._sleep``) and run back to
    back, so a wrapper whose Python takes longer than its kernel is not
    timed by its Python.  Used beside ``ms`` for the gate kernels, whose
    kernels are shorter than their wrappers."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    """Bytes of the storage each tensor really occupies (an expanded view
    counts once)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
        total += n * t.element_size()
    return total


def valid_taps(size: int, stride: int) -> int:
    """Sum over output positions of the 3-tap window's in-bounds taps."""
    from repro_torch.kernels.ref import same_pads
    out, lo, _ = same_pads(size, stride, 3)
    return sum(1 for o in range(out) for k in range(3)
               if 0 <= o * stride - lo + k < size)


KERNEL_TEMPLATES = ("gate_conv3x3_kernel", "gate_conv3x3_tf32x3_kernel",
                    "split_weights_kernel", "gate_matmul_fma_kernel",
                    "gate_matmul_wgmma_kernel", "gate_bwd_kernel",
                    "poly_reduce_kernel", "gate_kernel",
                    "rwkv6_scan_tf32x3_kernel", "rwkv6_scan_kernel")


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory and spills per ``__global__`` template, from
    what ``nvcc -Xptxas -v`` printed (ranges over the instantiations)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = next((t for t in KERNEL_TEMPLATES if t in ln), "other")
            # the template arguments, as mangled
            entry = ln.split(name)[-1].split("EEEv")[0] \
                if name != "other" else ""
            out.setdefault(name, {"instantiations": 0, "registers": [],
                                  "smem_bytes": [], "spill_bytes": 0})
            out[name]["instantiations"] += 1
        elif name and "bytes spill stores" in ln:
            nums = [int(t) for t in ln.replace(",", " ").split()
                    if t.isdigit()]
            out[name]["spill_bytes"] += sum(nums[1:3])
            if sum(nums[1:3]):
                out[name].setdefault("spilling", []).append(entry)
        elif name and "Used" in ln and "registers" in ln:
            toks = ln.replace(",", " ").split()
            out[name]["registers"].append(int(toks[toks.index("Used") + 1]))
            if "smem" in toks:
                out[name]["smem_bytes"].append(
                    int(toks[toks.index("smem") - 2]))
    for v in out.values():
        for key in ("registers", "smem_bytes"):
            v[key] = [min(v[key]), max(v[key])] if v[key] else []
    return out


# --------------------------------------------------------------- kernel cases


def gate_case(name, dtype, kind, n, rows, cols, poly, shared_x, primary,
              seed, timed=False):
    """One comparison of the gate kernel with its plain version."""
    from repro_torch.kernels import masked_act as K, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    batched = name == "masked_act_2d_batched"
    base = torch.randn((1 if shared_x or not batched else n, rows, cols),
                       generator=g, device="cuda").to(dtype)
    if batched:
        x = base.expand(n, rows, cols) if shared_x else base
        mask = (torch.rand((n, cols), generator=g, device="cuda") < 0.6
                ).float()
    else:
        x = base[0]
        mask = (torch.rand((cols,), generator=g, device="cuda") < 0.6
                ).float()
    if poly:       # real-valued masks and a poly2 replacement together
        mask = torch.rand(mask.shape, generator=g, device="cuda")
    p = torch.randn((3, cols), generator=g, device="cuda") * 0.3 \
        if poly else None

    def kernel():
        return (K.masked_act_2d_batched if batched else K.masked_act_2d)(
            x, mask, p, kind=kind)

    def plain():
        m = mask[:, None, :] if batched else mask
        if dtype == torch.float32:
            return ref.masked_act_ref(x, m, kind=kind, poly=p)
        return ref.masked_act_ref(x.float(), m, kind=kind, poly=p).to(dtype)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    n_el = out.numel()
    byts = nbytes(x, mask, p) + out.numel() * out.element_size()
    flops = n_el * (5 + (5 if poly else 0))
    return finish_case(name, "gate", dtype, out, want, kernel, plain, False,
                       byts, flops, primary,
                       dict(kind=kind, shape=list(x.shape), poly=poly,
                            shared_x=shared_x), timed)


def gate_bwd_case(kind, rows, cols, poly, primary, seed, timed=False):
    """The gate's backward kernel against ``ref.masked_act_bwd_ref``: x with
    exact zeros (relu′(0) = 1/2), a binary mask, and with ``poly`` the
    poly2 replacement and its gradient, whose row sum must also come out
    the same, bit for bit, from a second launch."""
    from repro_torch.kernels import masked_act as K, ref
    name = "masked_act_2d_bwd"
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device="cuda")
    x.view(-1)[::7] = 0.0
    mask = (torch.rand((cols,), generator=g, device="cuda") < 0.6).float()
    grad = torch.randn((rows, cols), generator=g, device="cuda")
    p = torch.randn((3, cols), generator=g, device="cuda") * 0.3 \
        if poly else None

    def kernel():
        return K.masked_act_2d_bwd(x, mask, grad, p, kind=kind,
                                   need_dpoly=poly)

    def plain():
        return ref.masked_act_bwd_ref(x, mask, grad, kind, p, poly)

    (dx, dpoly), (want_dx, want_dp) = kernel(), plain()
    torch.cuda.synchronize()
    extra = dict(kind=kind, shape=[rows, cols], poly=poly, shared_x=False,
                 zeros_in_x=int((x == 0).sum()))
    if poly:
        g1m = grad * (1.0 - mask)
        terms = torch.stack([(g1m * x * x).abs().sum(0),
                             (g1m * x).abs().sum(0), g1m.abs().sum(0)])
        bound = 1e-7 + 2 * (rows - 1) * 2.0 ** -24 * terms
        err = (dpoly - want_dp).abs()
        extra["dpoly_max_abs_err"] = float(err.max())
        extra["dpoly_tol"] = "1e-7 + 2*(rows-1)*2^-24*sum|terms|"
        if not torch.isfinite(dpoly).all() or bool((err > bound).any()):
            fail(f"{name} {extra}: dpoly misses its tolerance")
        again = kernel()[1]
        torch.cuda.synchronize()
        if not torch.equal(again, dpoly):
            fail(f"{name} {extra}: two launches gave different dpoly bits")
        del again, err, terms, bound
    n_el = rows * cols
    byts = nbytes(x, mask, grad, p) + 4 * n_el + (12 * cols if poly else 0)
    flops = n_el * (6 + (9 if poly else 0))
    return finish_case(name, "gate_bwd", torch.float32, dx, want_dx, kernel,
                       plain, False, byts, flops, primary, extra, timed)


class forced_route:
    """Within the block, every call that ``module.<rule>`` routes takes
    ``route`` whatever the rule says: chip_smoke.py times the fused conv's
    route F beside route T (``masked_act.conv_route``) and the scan's route
    S beside route C (``rwkv6_scan.scan_route``) at the path's shapes with
    it.  The port itself never forces a route."""

    def __init__(self, module, rule, route):
        self.module, self.name, self.route = module, rule, route

    def __enter__(self):
        self.rule = getattr(self.module, self.name)
        setattr(self.module, self.name, lambda *a, **k: self.route)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.rule)


def conv_case(name, dtype, kind, n, b, h, w_, cin, cout, stride, shared_x,
              primary, seed, timed=False):
    """One comparison of the fused gate→conv kernel with the unfused pair.
    At the path's batch in float32 the case must take route T and keep its
    error against a float64 convolution within ``CONV_ERR_RATIO`` times the
    plain version's; route F is run, checked and timed there too."""
    from repro_torch.kernels import build, masked_act as K, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    batched = name == "masked_act_conv3x3_batched"
    base = torch.randn((1 if shared_x or not batched else n, b, h, w_, cin),
                       generator=g, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=g, device="cuda")
          * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    if batched:
        x = base.expand(n, b, h, w_, cin) if shared_x else base
        mask = (torch.rand((n, h, w_, cin), generator=g, device="cuda")
                < 0.6).float()
    else:
        x = base[0]
        mask = (torch.rand((h, w_, cin), generator=g, device="cuda")
                < 0.6).float()

    def kernel():
        f = K.masked_act_conv3x3_batched if batched else K.masked_act_conv3x3
        return f(x, mask, wt, stride=stride, kind=kind)

    def plain():
        if dtype == torch.float32:
            return ref.masked_act_conv3x3_ref(x, mask, wt, stride=stride,
                                              kind=kind)
        return ref.masked_act_conv3x3_ref(
            x.float(), mask, wt.float(), stride=stride, kind=kind).to(dtype)

    before = dict(build.route_counts)
    out = kernel()
    routes = [r.split(":")[1] for r, v in build.route_counts.items()
              if v != before[r]]
    want = plain()
    torch.cuda.synchronize()
    if len(routes) != 1:
        fail(f"{name}: one launch took routes {routes}")
    byts = nbytes(x, mask, wt) + out.numel() * out.element_size()
    cands = n if batched else 1
    flops = 2.0 * cands * b * valid_taps(h, stride) * \
        valid_taps(w_, stride) * cin * cout
    extra = dict(conv_route=routes[0], kind=kind, shape=list(x.shape),
                 cout=cout, stride=stride, shared_x=shared_x)
    path_shaped = dtype == torch.float32 and b == RESNET_BATCH
    if path_shaped and routes[0] != "tf32x3":
        fail(f"{name} {extra}: a float32 case at the path's batch took "
             f"route {routes[0]}")
    if path_shaped or (dtype == torch.float32 and primary):
        exact = ref.masked_act_conv3x3_ref(
            x.double(), mask.double(), wt.double(), stride=stride, kind=kind)
        extra["kernel_err_vs_f64"] = float((out.double() - exact).abs().max())
        extra["plain_err_vs_f64"] = float((want.double() - exact).abs().max())
        if path_shaped:
            with forced_route(K, "conv_route", "fma"):
                fma = kernel()
            torch.cuda.synchronize()
            extra["fma_err_vs_f64"] = float((fma.double() - exact).abs()
                                            .max())
            atol, rtol = TOL[("conv", dtype)]
            err = (fma - want).abs()
            extra["fma_max_abs_err"] = float(err.max())
            if bool((err > atol + rtol * want.abs()).any()):
                fail(f"{name} {extra}: route F misses the tolerance")
            del fma, err
            if not extra["kernel_err_vs_f64"] <= \
                    CONV_ERR_RATIO * extra["plain_err_vs_f64"]:
                fail(f"{name} {extra}: route T's error against float64 is "
                     f"above {CONV_ERR_RATIO}x the plain version's")
        del exact
    if path_shaped and (primary or timed):
        with forced_route(K, "conv_route", "fma"):
            extra["fma_ms"] = time_ms(kernel)
    extra["bound_fma_ms"] = max(byts / HBM_BYTES_PER_S,
                                flops / FP32_FLOP_PER_S) * 1e3
    extra["bound_tf32x3_ms"] = max(byts / HBM_BYTES_PER_S,
                                   3 * flops / TF32_FLOP_PER_S) * 1e3
    # library yardstick: the gate, then the one library call (F.conv2d) that
    # computes the product — which is what the plain version is
    return finish_case(name, "conv", dtype, out, want, kernel, plain,
                       True, byts, flops, primary, extra, timed,
                       rate=TF32_FLOP_PER_S / 3 if routes[0] == "tf32x3"
                       else None)


def matmul_case(name, dtype, kind, n, rows, k, nout, with_mul, shared_x,
                primary, seed, timed=False):
    """One comparison of the fused gate→matmul kernel with the unfused
    pair (the plain version); the library yardstick is the gate kernel
    followed by ``torch.matmul``, the model's unfused route."""
    from repro_torch.kernels import masked_act as K, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    batched = name == "masked_act_matmul_2d_batched"
    lead = (1 if shared_x or not batched else n, rows, k)
    base = torch.randn(lead, generator=g, device="cuda").to(dtype)
    ubase = torch.randn(lead, generator=g, device="cuda").to(dtype) \
        if with_mul else None
    wt = (torch.randn((k, nout), generator=g, device="cuda")
          * k ** -0.5).to(dtype)
    if batched:
        x = base.expand(n, rows, k) if shared_x else base
        mul = None if ubase is None else (
            ubase.expand(n, rows, k) if shared_x else ubase)
        mask = (torch.rand((n, k), generator=g, device="cuda") < 0.6
                ).float()
    else:
        x, mul = base[0], None if ubase is None else ubase[0]
        mask = (torch.rand((k,), generator=g, device="cuda") < 0.6).float()

    def kernel():
        f = K.masked_act_matmul_2d_batched if batched else \
            K.masked_act_matmul_2d
        return f(x, mask, wt, mul, kind=kind)

    def plain(double=False):
        # in x's dtype: in bfloat16 every elementwise step rounds to
        # bfloat16, as the reference's kernel rounds
        f = ref.masked_act_matmul_batched_ref if batched else \
            ref.masked_act_matmul_ref
        if double:
            return f(x.double(), mask.double(), wt.double(),
                     None if mul is None else mul.double(), kind=kind)
        return f(x, mask, wt, mul, kind=kind)

    def library():
        gate = K.masked_act_2d_batched(x, mask, kind=kind) if batched \
            else K.masked_act_2d(x, mask, kind=kind)
        if mul is not None:
            gate = gate * mul
        return torch.matmul(gate, wt)

    from repro_torch.kernels import build
    before = dict(build.route_counts)
    out = kernel()
    routes = [r.split(":")[1] for r, v in build.route_counts.items()
              if v != before[r]]
    want = plain()
    torch.cuda.synchronize()
    if len(routes) != 1:
        fail(f"{name}: one launch took routes {routes}")
    if dtype == torch.bfloat16 and (rows, k, nout) in LM_MATMUL_SHAPES and \
            routes[0] != "wgmma":
        fail(f"{name} bfloat16 at the LM shape took route {routes[0]}")
    cands = n if batched else 1
    byts = nbytes(x, mask, mul, wt) + out.numel() * out.element_size()
    flops = 2.0 * cands * rows * k * nout
    extra = dict(matmul_route=routes[0], kind=kind, shape=list(x.shape),
                 n_out=nout, mul=with_mul, shared_x=shared_x)
    if dtype == torch.bfloat16:
        # the unfused route feeds the product the same bfloat16 operands
        unf = library()
        torch.cuda.synchronize()
        atol, rtol = TOL[("matmul", dtype)]
        err = (out.float() - unf.float()).abs()
        extra["max_abs_err_vs_unfused"] = float(err.max())
        if bool((err > atol + rtol * unf.float().abs()).any()):
            fail(f"{name} {extra}: differs from the unfused route by "
                 f"{float(err.max())}")
        del unf, err
    if dtype == torch.float32 and (primary or timed):
        exact = plain(double=True)
        extra["kernel_err_vs_f64"] = float((out.double() - exact).abs().max())
        extra["plain_err_vs_f64"] = float((want.double() - exact).abs().max())
        del exact
    return finish_case(name, "matmul", dtype, out, want, kernel, plain,
                       False, byts, flops, primary, extra, timed,
                       library=library)


def scan_case(bh, T, K, V, chunk, heads, shared_state, primary, seed,
              timed=False, with_serial=False, strong=False):
    """One comparison of the RWKV-6 scan, on the route the rule picks
    (route C), with its chunked plain version, and of both with the
    token-serial recurrence in float64: the kernel's error against it must
    stay within ``SCAN_ERR_RATIO`` times the plain version's.  ``heads``: u
    is an (H, K) per-head table (the path's layout); 0: a full (BH, K) u; 1:
    one row expanded with stride 0.  ``shared_state``: the initial state is
    one zero (K, V) expanded with stride 0, as the path passes it;
    otherwise a random state per row.  ``with_serial``: route S is forced
    beside it, held to the same tolerance, and timed.  ``strong``: decays
    w = exp(-exp(U(-1, 3))), down to 2e-9, instead of the reference test's
    U(0.7, 0.999); the plain version divides by in-chunk decay products
    that underflow there and is not finite (recorded), so the case is held
    to the float64 recurrence: route C finite, its error within
    ``SCAN_ERR_RATIO`` times route S's."""
    from repro_torch.kernels import build, ref, rwkv6_scan as RS
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    r, k = randn(bh, T, K, scale=0.5), randn(bh, T, K, scale=0.5)
    v = randn(bh, T, V)
    uniform = torch.rand((bh, T, K), generator=g, device="cuda")
    # the reference test's decays (tests/test_kernels.py:233), or strong ones
    w = torch.exp(-torch.exp(4.0 * uniform - 1.0)) if strong else \
        0.7 + 0.299 * uniform
    u = randn(heads or bh, K, scale=0.3)
    if heads == 1:
        u = u.expand(bh, K)
    state = torch.zeros((1, K, V), device="cuda").expand(bh, K, V) \
        if shared_state else randn(bh, K, V, scale=0.1)

    def kernel():
        return RS.rwkv6_scan(r, k, v, w, u, state, chunk=chunk)

    def plain():
        return ref.rwkv6_scan_ref(r, k, v, w, u, state, chunk=chunk)

    def flat(pair):
        return torch.cat([pair[0].flatten(), pair[1].flatten()])
    before = dict(build.route_counts)
    out = flat(kernel())
    routes = [n.split(":")[1] for n, c in build.route_counts.items()
              if c != before[n]]
    want = flat(plain())
    torch.cuda.synchronize()
    rule = RS.scan_route(torch.float32, bh, T, K, V)
    if routes != [rule]:
        fail(f"rwkv6_scan {[bh, T, K, V]}: took routes {routes}, the rule "
             f"says {rule}")
    exact = flat(ref.rwkv6_serial_ref(*(t.double() for t in
                                        (r, k, v, w, u, state))))

    def err64(x):
        return float((x.double() - exact).abs().max())
    plain_finite = bool(torch.isfinite(want).all())
    extra = dict(scan_route=rule, shape=[bh, T, K, V], chunk=chunk,
                 decay="exp(-exp(U(-1, 3)))" if strong else
                 "U(0.7, 0.999)",
                 u="(H, K) table" if heads > 1 else
                 "stride-0 row" if heads == 1 else "(BH, K)",
                 state="shared zeros" if shared_state else "random",
                 kernel_err_vs_f64=err64(out),
                 plain_err_vs_f64=err64(want) if plain_finite else None,
                 plain_finite=plain_finite)
    atol, rtol = TOL[("scan", torch.float32)]
    if with_serial or strong:
        with forced_route(RS, "scan_route", "serial"):
            serial = flat(kernel())
        torch.cuda.synchronize()
        extra["serial_err_vs_f64"] = err64(serial)
        if plain_finite:
            err = (serial - want).abs()
            extra["serial_max_abs_err"] = float(err.max())
            if bool((err > atol + rtol * want.abs()).any()):
                fail(f"rwkv6_scan {extra}: route S misses the tolerance")
        del serial
    byts = nbytes(r, k, v, w, u, state) + 4 * (bh * T * V + bh * K * V)
    # per token and row: r.S (2KV), the state update (3KV), the bonus
    flops = bh * T * (5.0 * K * V + 3 * K + 2 * V)
    if with_serial and (primary or timed):
        with forced_route(RS, "scan_route", "serial"):
            extra["serial_ms"] = time_ms(kernel)
    if not strong:
        if not extra["kernel_err_vs_f64"] <= \
                SCAN_ERR_RATIO * extra["plain_err_vs_f64"]:
            fail(f"rwkv6_scan {extra}: route {rule}'s error against float64 "
                 f"is above {SCAN_ERR_RATIO}x the plain version's")
        del exact
        return finish_case("rwkv6_scan", "scan", torch.float32, out, want,
                           kernel, plain, False, byts, flops, primary, extra,
                           timed)
    # strong decay: held to the float64 recurrence, not to the plain version
    if not torch.isfinite(out).all():
        fail(f"rwkv6_scan {extra}: route {rule} is not finite under strong "
             "decay")
    if not extra["kernel_err_vs_f64"] <= \
            SCAN_ERR_RATIO * extra["serial_err_vs_f64"]:
        fail(f"rwkv6_scan {extra}: route {rule}'s error against float64 is "
             f"above {SCAN_ERR_RATIO}x route S's under strong decay")
    case = dict(name="rwkv6_scan", dtype="float32",
                max_abs_err=extra["kernel_err_vs_f64"],
                held_to="the float64 token loop", primary=primary, **extra)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    with forced_route(RS, "scan_route", "serial"):
        case["serial_ms"] = time_ms(kernel)
    case.update(ms=time_ms(kernel), queued_ms=queued_ms(kernel),
                plain_ms=time_ms(plain),
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=byts, flops=flops)
    del out, want, exact
    torch.cuda.empty_cache()
    return case


def scan_bwd_case(bh, T, K, V, heads, shared_state, with_ds_end, primary,
                  seed, timed=False, strong=False):
    """The scan's backward kernel (``rwkv6_scan_bwd``) against its plain
    version ``ref.rwkv6_scan_bwd_ref`` on the same inputs, gradient by
    gradient (``SCAN_BWD_ATOL``, ``SCAN_BWD_RTOL``), and both against the
    plain backward in float64 (the kernel's error within
    ``SCAN_ERR_RATIO`` times the plain version's); a second launch must
    give the same bits (du is summed over each head's rows in a fixed
    order).  ``heads``, ``shared_state`` and ``strong`` as
    :func:`scan_case`; the path's calls have a stride-0 zero state that
    needs no gradient and no gradient of the final state
    (``with_ds_end=False``: ds0 is not asked for)."""
    from repro_torch.kernels import ref, rwkv6_scan as RS
    name = "rwkv6_scan_bwd"
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    r, k = randn(bh, T, K, scale=0.5), randn(bh, T, K, scale=0.5)
    v = randn(bh, T, V)
    uniform = torch.rand((bh, T, K), generator=g, device="cuda")
    w = torch.exp(-torch.exp(4.0 * uniform - 1.0)) if strong else \
        0.7 + 0.299 * uniform
    u = randn(heads or bh, K, scale=0.3)
    if heads == 1:
        u = u.expand(bh, K)
    state = torch.zeros((1, K, V), device="cuda").expand(bh, K, V) \
        if shared_state else randn(bh, K, V, scale=0.1)
    dy = randn(bh, T, V)
    ds_end = randn(bh, K, V) if with_ds_end else None
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    def kernel():
        return RS.rwkv6_scan_bwd(r, k, v, w, u, state, dy, ds_end,
                                 need_ds0=with_ds_end)

    def plain():
        return ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_end)

    got, want = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    extra = dict(shape=[bh, T, K, V],
                 decay="exp(-exp(U(-1, 3)))" if strong else "U(0.7, 0.999)",
                 u="(H, K) table" if heads > 1 else
                 "stride-0 row" if heads == 1 else "(BH, K)",
                 state="shared zeros" if shared_state else "random",
                 ds_end=with_ds_end,
                 tol=f"{SCAN_BWD_ATOL}*max|plain| + {SCAN_BWD_RTOL}*|plain|")
    for n_, a, b in zip(names, got, again):
        if a is not None and not torch.equal(a, b):
            fail(f"{name} {extra}: two launches gave different {n_} bits")
    del again
    f64 = ref.rwkv6_scan_bwd_ref(*(t.double() for t in (r, k, v, w, u,
                                                       state, dy)),
                                 None if ds_end is None else ds_end.double())
    max_err, errs = 0.0, {}
    for n_, a, b, c in zip(names, got, want, f64):
        if a is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name} {extra}: {n_} {tuple(a.shape)} is not finite or "
                 f"not the plain version's {tuple(b.shape)}")
        scale = float(b.abs().max())
        err = (a - b).abs()
        if bool((err > SCAN_BWD_ATOL * scale + SCAN_BWD_RTOL * b.abs())
                .any()):
            fail(f"{name} {extra}: {n_} misses its tolerance by "
                 f"{float(err.max())} (scale {scale})")
        k_err = float((a.double() - c).abs().max())
        p_err = float((b.double() - c).abs().max())
        if not k_err <= SCAN_ERR_RATIO * p_err:
            fail(f"{name} {extra}: {n_}'s error against float64 {k_err} is "
                 f"above {SCAN_ERR_RATIO}x the plain version's {p_err}")
        errs[n_] = dict(max_abs_err=float(err.max()), scale=scale,
                        kernel_err_vs_f64=k_err, plain_err_vs_f64=p_err)
        max_err = max(max_err, float(err.max()))
    del f64, got, want
    torch.cuda.empty_cache()
    case = dict(name=name, dtype="float32", max_abs_err=max_err,
                atol=SCAN_BWD_ATOL, rtol=SCAN_BWD_RTOL, primary=primary,
                errors=errs, **extra)
    if primary or timed:
        # read r, k, v, w, u, the state, dy (and ds_end) once, write dr, dk,
        # dv, dw, du (and ds0) once; per token and row: the state step
        # recomputed once (2KV), dS's step, dr, dk, dv, dw (2KV each)
        byts = nbytes(r, k, v, w, u, state, dy, ds_end) + 4 * (
            3 * bh * T * K + bh * T * V + u.shape[0] * K +
            (bh * K * V if with_ds_end else 0))
        flops = bh * T * 12.0 * K * V
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        case.update(ms=time_ms(kernel), queued_ms=queued_ms(kernel),
                    plain_ms=time_ms(plain, reps=3, warm=1),
                    library_ms=None, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=byts, flops=flops)
    torch.cuda.empty_cache()
    return case


def finish_case(name, family, dtype, out, want, kernel, plain,
                plain_is_library, byts, flops, primary, extra, timed=False,
                library=None, rate=None):
    atol, rtol = TOL[(family, dtype)]
    if out.shape != want.shape or out.dtype != want.dtype:
        fail(f"{name} {extra}: shape/dtype {tuple(out.shape)} {out.dtype} "
             f"vs plain {tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(out.float()).all():
        fail(f"{name} {extra}: non-finite output")
    err = (out.float() - want.float()).abs()
    bad = err > (atol + rtol * want.float().abs())
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        fail(f"{name} {extra}: max abs err {max_err} exceeds "
             f"{atol} + {rtol}*|ref| at {int(bad.sum())} elements")
    case = dict(name=name, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=max_err, atol=atol, rtol=rtol, primary=primary,
                **extra)
    if primary or timed:
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        if rate is None:
            rate = BF16_FLOP_PER_S if (family == "matmul" and
                                       dtype == torch.bfloat16) \
                else FP32_FLOP_PER_S
        t_ops = flops / rate * 1e3
        plain_ms = time_ms(plain)
        library_ms = plain_ms if plain_is_library else None
        if library is not None:
            library_ms = time_ms(library)
        case.update(
            ms=time_ms(kernel), plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=byts, flops=flops)
        if family in ("gate", "gate_bwd", "scan"):
            case["queued_ms"] = queued_ms(kernel)
    del out, want
    torch.cuda.empty_cache()
    return case


def matmul_routes(name, mine, by_path) -> dict:
    """The fused matmul's two routes side by side: each one's source, its
    launches on the main paths, and the times of its silu case at the
    path's shape, un-shared (float32 for route B, bfloat16 for route A)."""
    out = {}
    for route, dtype in (("fma", "float32"), ("wgmma", "bfloat16")):
        timed = [c for c in mine if c.get("matmul_route") == route and
                 c["dtype"] == dtype and "ms" in c and not c["shared_x"]
                 and c["kind"] == "silu"]
        c = max(timed, key=lambda c: c["flops"])
        out[route] = {
            "source": SOURCE[route],
            "launches": sum(p[f"{name}:{route}"] for p in by_path.values()),
            **{k: c[k] for k in ("dtype", "shape", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
            **{key: max((x["max_abs_err"] for x in mine
                         if x.get("matmul_route") == route and
                         x["dtype"] == dt), default=None)
               for key, dt in (("max_abs_err", "float32"),
                               ("max_abs_err_bf16", "bfloat16"))}}
    return out


def conv_routes(name, mine, by_path) -> dict:
    """The fused conv's two routes side by side (each one's source and
    launches on the main paths), and its float32 cases at the path's batch
    stage by stage: route T's and route F's times, gate + cuDNN's, both
    bounds, and the errors against a float64 convolution."""
    by_route = {route: {
        "source": CONV_SOURCE[route],
        "launches": sum(p[f"{name}:{route}"] for p in by_path.values()),
        "max_abs_err": max((c["max_abs_err"] for c in mine
                            if c["conv_route"] == route), default=None)}
        for route in ("tf32x3", "fma")}
    by_stage = []
    for hw, c in STAGES:
        case = next(x for x in mine if "fma_ms" in x and not x["shared_x"]
                    and x["shape"][-3:] == [hw, hw, c] and x["stride"] == 1)
        by_stage.append({k: case[k] for k in (
            "shape", "conv_route", "ms", "fma_ms", "library_ms",
            "bound_tf32x3_ms", "bound_fma_ms", "kernel_err_vs_f64",
            "fma_err_vs_f64", "plain_err_vs_f64")})
    return {"by_route": by_route, "by_stage": by_stage}


def scan_routes(mine, by_path) -> dict:
    """The scan's two routes side by side (each one's source, launches on
    the main paths and largest error against the plain version), and every
    case where route S ran beside route C: both routes' times, the plain
    version's, the bound, and the three errors against the float64 token
    loop."""
    by_route = {route: {
        "source": SCAN_SOURCE[route],
        "launches": sum(p[f"rwkv6_scan:{route}"] for p in by_path.values())}
        for route in ("tf32x3", "serial")}
    by_route["tf32x3"]["max_abs_err"] = max(
        c["max_abs_err"] for c in mine if c["plain_finite"])
    by_route["serial"]["max_abs_err"] = max(
        c["serial_max_abs_err"] for c in mine if "serial_max_abs_err" in c)
    by_shape = [{k: c.get(k) for k in (
        "shape", "decay", "scan_route", "ms", "queued_ms", "serial_ms",
        "plain_ms", "bound_ms", "kernel_err_vs_f64", "serial_err_vs_f64",
        "plain_err_vs_f64", "plain_finite")}
        for c in mine if "serial_err_vs_f64" in c]
    return {"by_route": by_route, "by_shape": by_shape}


def time_scan_copies(scan_ms: float) -> dict:
    """The RWKV-6 time-mix's head-major copies around its scan
    (``models/ssm.py`` ``rwkv_time_mix``: ``heads()`` on r, k, v and the
    decays, (G, S, H·hd) -> (G·H, S, hd), and the transpose of y back), at
    the path's stacked shape, G = LM_CHUNK candidates x LM_BATCH sequences,
    timed beside the scan they feed (``scan_ms``, the primary case's).  The
    same tensor operations as the model's, on random activations."""
    G, S, H, hd = LM_CHUNK * LM_BATCH, LM_PATHS[1].seq - 1, 40, 64
    x = torch.randn((G, S, H * hd), device="cuda")
    yh = torch.randn((G * H, S, hd), device="cuda")

    def heads(t):
        return t.to(torch.float32).reshape(G, S, H, hd).transpose(1, 2) \
            .reshape(G * H, S, hd)

    def back(t):
        return t.reshape(G, H, S, hd).transpose(1, 2).reshape(G, S, H * hd)
    heads_ms, back_ms = time_ms(lambda: heads(x)), time_ms(lambda: back(yh))
    per_copy = 2 * x.numel() * x.element_size()
    copies_ms = 4 * heads_ms + back_ms
    return {"shape": [G, S, H, hd], "heads_ms_each": heads_ms,
            "back_ms": back_ms, "copies_ms_per_time_mix": copies_ms,
            "bytes_per_time_mix": 5 * per_copy,
            "bound_ms": 5 * per_copy / HBM_BYTES_PER_S * 1e3,
            "scan_ms": scan_ms, "copies_vs_scan": copies_ms / scan_ms}


def run_kernel_cases():
    """Every kernel at the shapes the main path gives it (eval batch 128,
    chunks of 8 candidates, the four ResNet18 stages, the serving path's
    decode ticks and prefills) and at ragged small
    shapes in all four kinds, float32 and bfloat16, with and without a
    shared (stride-0) activation.  ``primary`` marks the case whose times go
    into the ``kernels`` line; ``timed`` cases are timed as well."""
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = ("relu", "gelu", "silu", "sqrelu")
    stages = STAGES
    cases = []

    # ---- masked_act_2d: the sequential engine's gate
    g2 = "masked_act_2d"
    for i, (hw, c) in enumerate((stages[0], stages[3])):
        cases.append(gate_case(g2, f32, "relu", n=1, rows=128,
                               cols=hw * hw * c, poly=False, shared_x=False,
                               primary=i == 0, seed=1 + i))
    for i, kind in enumerate(kinds):
        cases.append(gate_case(g2, f32, kind, n=1, rows=37, cols=203,
                               poly=i % 2 == 0, shared_x=False,
                               primary=False, seed=10 + i))
        cases.append(gate_case(g2, bf16, kind, n=1, rows=64, cols=1000,
                               poly=i % 2 == 1, shared_x=False,
                               primary=False, seed=20 + i))
    # the serving path's gates, binary masks: StableLM-2-1.6B's silu FFN at
    # a decode tick of every slot and at a B=1 prefill of the longest
    # bucket; RWKV-6 3B's channel-mix sqrelu at a decode step of the batch
    # and at its batched prefill
    for i, (kind, rows, cols) in enumerate((
            ("silu", SERVE_SLOTS, 5632),
            ("silu", SERVE_PREFILL_LENS[-1], 5632),
            ("sqrelu", RWKV_SERVE_BATCH, 8960),
            ("sqrelu", RWKV_SERVE_BATCH * RWKV_SERVE_PROMPT, 8960))):
        cases.append(gate_case(g2, f32, kind, n=1, rows=rows, cols=cols,
                               poly=False, shared_x=False, primary=False,
                               seed=190 + i, timed=True))

    # ---- masked_act_2d_bwd: every ResNet18 site shape of the train step
    # at batch 32 (the stem and stage 0, then stages 1-3), relu with the
    # identity, and relu with poly2 and its gradient; ragged small shapes
    # in all four kinds (203 columns take the scalar loads)
    for i, (hw, c) in enumerate(stages):
        cases.append(gate_bwd_case("relu", TRAIN_BATCH, hw * hw * c, False,
                                   primary=i == 0, seed=160 + i,
                                   timed=i == 3))
    for i, (hw, c) in enumerate((stages[0], stages[3])):
        cases.append(gate_bwd_case("relu", TRAIN_BATCH, hw * hw * c, True,
                                   primary=False, seed=165 + i, timed=True))
    for i, kind in enumerate(kinds):
        for poly in (False, True):
            cases.append(gate_bwd_case(kind, 37, 203, poly, primary=False,
                                       seed=170 + 2 * i + poly))
            cases.append(gate_bwd_case(kind, 9, 96, poly, primary=False,
                                       seed=180 + 2 * i + poly))

    # ---- masked_act_2d_batched: a chunk of 8 candidates
    g2b = "masked_act_2d_batched"
    cases.append(gate_case(g2b, f32, "relu", n=8, rows=128, cols=32 * 32 * 64,
                           poly=False, shared_x=False, primary=True, seed=3))
    cases.append(gate_case(g2b, f32, "relu", n=8, rows=128, cols=32 * 32 * 64,
                           poly=False, shared_x=True, primary=False, seed=4,
                           timed=True))
    cases.append(gate_case(g2b, f32, "relu", n=8, rows=128, cols=4 * 4 * 512,
                           poly=False, shared_x=False, primary=False, seed=5,
                           timed=True))
    # the MoE and hybrid paths' silu gates, un-stacked and in chunks of
    # LM_CHUNK candidates: DeepSeek-MoE-16B's routed experts, rows B·C of
    # E·F columns (C slots an expert, 16 at 127 tokens; the first MoE
    # layer after a cut reads a shared x), and Zamba2-2.7B's Mamba2 gate,
    # rows B·S of d_inner
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    moe_path = FAMILY_PATHS[0]
    moe_rows = LM_BATCH * moe._capacity(
        lm._moe_cfg(get_config(moe_path.arch)), moe_path.seq - 1)
    mamba_rows = LM_BATCH * (FAMILY_PATHS[1].seq - 1)
    for i, (rows, cols) in enumerate(((moe_rows, 64 * 1408),
                                      (mamba_rows, 5120))):
        cases.append(gate_case(g2, f32, "silu", n=1, rows=rows, cols=cols,
                               poly=False, shared_x=False, primary=False,
                               seed=200 + i, timed=True))
        cases.append(gate_case(g2b, f32, "silu", n=LM_CHUNK, rows=rows,
                               cols=cols, poly=False, shared_x=False,
                               primary=False, seed=202 + i, timed=True))
    cases.append(gate_case(g2b, f32, "silu", n=LM_CHUNK, rows=moe_rows,
                           cols=64 * 1408, poly=False, shared_x=True,
                           primary=False, seed=204, timed=True))
    for i, kind in enumerate(kinds):
        cases.append(gate_case(g2b, f32, kind, n=3, rows=5, cols=77,
                               poly=i % 2 == 1, shared_x=i % 2 == 0,
                               primary=False, seed=30 + i))
        cases.append(gate_case(g2b, bf16, kind, n=3, rows=9, cols=264,
                               poly=i % 2 == 0, shared_x=i % 2 == 1,
                               primary=False, seed=40 + i))

    # ---- masked_act_conv3x3: un-stacked fused forward, relu1 -> conv2, at
    # the four stages
    c3 = "masked_act_conv3x3"
    for i, (hw, c) in enumerate(stages):
        cases.append(conv_case(c3, f32, "relu", n=1, b=RESNET_BATCH, h=hw,
                               w_=hw, cin=c, cout=c, stride=1,
                               shared_x=False, primary=i == 0, seed=6 + i,
                               timed=True))
    cases.append(conv_case(c3, f32, "relu", n=1, b=128, h=16, w_=16, cin=128,
                           cout=128, stride=2, shared_x=False, primary=False,
                           seed=8))
    for i, kind in enumerate(kinds):
        for stride in (1, 2):
            cases.append(conv_case(c3, f32, kind, n=1, b=3, h=7 + i % 2,
                                   w_=6 - i % 2, cin=5, cout=6, stride=stride,
                                   shared_x=False, primary=False,
                                   seed=50 + 2 * i + stride))
        cases.append(conv_case(c3, bf16, kind, n=1, b=4, h=8, w_=8, cin=16,
                               cout=24, stride=1 + i % 2, shared_x=False,
                               primary=False, seed=60 + i))
        # route T off the path's shapes: 64 images, a partial channel step
        # (Cin 40 = 32 + 8), Cout 72 in a 128-column tile, odd sizes
        cases.append(conv_case(c3, f32, kind, n=1, b=64, h=7, w_=9, cin=40,
                               cout=72, stride=1 + i % 2, shared_x=False,
                               primary=False, seed=140 + i))

    # ---- masked_act_conv3x3_batched: the suffix engine's fused forwards
    c3b = "masked_act_conv3x3_batched"
    for i, (hw, c) in enumerate(stages):
        cases.append(conv_case(c3b, f32, "relu", n=8, b=RESNET_BATCH, h=hw,
                               w_=hw, cin=c, cout=c, stride=1,
                               shared_x=False, primary=i == 0, seed=70 + i,
                               timed=True))
    cases.append(conv_case(c3b, f32, "relu", n=8, b=128, h=32, w_=32, cin=64,
                           cout=64, stride=1, shared_x=True, primary=False,
                           seed=75, timed=True))
    cases.append(conv_case(c3b, f32, "relu", n=8, b=128, h=16, w_=16, cin=128,
                           cout=128, stride=2, shared_x=False, primary=False,
                           seed=76))
    for i, kind in enumerate(kinds):
        cases.append(conv_case(c3b, f32, kind, n=3, b=2, h=5 + i % 2, w_=7,
                               cin=9, cout=10, stride=1 + i % 2,
                               shared_x=i % 2 == 0, primary=False,
                               seed=80 + i))
        cases.append(conv_case(c3b, bf16, kind, n=2, b=3, h=8, w_=8, cin=16,
                               cout=24, stride=2 - i % 2,
                               shared_x=i % 2 == 1, primary=False,
                               seed=90 + i))
        # route T: 192 images (a half-empty second image tile), Cout 264 in
        # two 256-column tiles, stacked and shared x
        cases.append(conv_case(c3b, f32, kind, n=3, b=192, h=6, w_=5, cin=24,
                               cout=264, stride=2 - i % 2,
                               shared_x=i % 2 == 0, primary=False,
                               seed=150 + i))

    # ---- masked_act_matmul_2d: the un-stacked fused LM forward, and
    # ---- masked_act_matmul_2d_batched: every FFN of a fused suffix forward
    # at the path's shape: rows = B·S, K = d_ff, N_out = d_model of
    # StableLM-2-1.6B, chunks of LM_CHUNK candidates
    rows, k, nout = LM_BATCH * (LM_PATHS[0].seq - 1), 5632, 2048
    m2, m2b = "masked_act_matmul_2d", "masked_act_matmul_2d_batched"
    cases.append(matmul_case(m2, f32, "silu", 1, rows, k, nout, True, False,
                             primary=True, seed=100))
    cases.append(matmul_case(m2b, f32, "silu", LM_CHUNK, rows, k, nout, True,
                             False, primary=True, seed=101))
    cases.append(matmul_case(m2b, f32, "silu", LM_CHUNK, rows, k, nout, True,
                             True, primary=False, seed=102, timed=True))
    cases.append(matmul_case(m2b, bf16, "silu", LM_CHUNK, rows, k, nout,
                             True, False, primary=False, seed=103,
                             timed=True))
    cases.append(matmul_case(m2b, bf16, "silu", LM_CHUNK, rows, k, nout,
                             True, True, primary=False, seed=105,
                             timed=True))
    # the same products behind the cheapest gate: what the silu gate costs
    for dt, seed in ((f32, 106), (bf16, 107)):
        cases.append(matmul_case(m2b, dt, "relu", LM_CHUNK, rows, k, nout,
                                 True, False, primary=False, seed=seed,
                                 timed=True))
    cases.append(matmul_case(m2, bf16, "silu", 1, rows, k, nout, True, False,
                             primary=False, seed=104, timed=True))
    # DeepSeek-MoE-16B's fused products under fused=, route B in float32:
    # its shared expert (K = d_ff_shared) and its dense head block (K =
    # d_ff), un-stacked and in chunks of LM_CHUNK candidates
    for i, k_moe in enumerate((2816, 10944)):
        cases.append(matmul_case(m2, f32, "silu", 1, rows, k_moe, nout, True,
                                 False, primary=False, seed=210 + 2 * i,
                                 timed=True))
        cases.append(matmul_case(m2b, f32, "silu", LM_CHUNK, rows, k_moe,
                                 nout, True, False, primary=False,
                                 seed=211 + 2 * i, timed=True))
    for i, kind in enumerate(kinds):
        for dt in (f32, bf16):
            # ragged in rows, K and N_out; K = 203 takes the scalar loads,
            # K = 96 the vector ones; every case is timed (microseconds)
            k1, k2 = (203, 96) if i < 2 else (96, 203)
            cases.append(matmul_case(m2, dt, kind, 1, 37, k1, 77 + 4 * i,
                                     i % 2 == 0, False, primary=False,
                                     seed=110 + 2 * i, timed=True))
            cases.append(matmul_case(m2b, dt, kind, 3, 37, k2, 72 + 5 * i,
                                     i % 2 == 1, i < 2, primary=False,
                                     seed=120 + 2 * i, timed=True))

    # ---- rwkv6_scan: every time-mix of the RWKV-6 3B path (40 heads of 64,
    # 128 tokens) stacked over a chunk of LM_CHUNK candidates and un-stacked;
    # the reference test's shapes; a chunk of the whole sequence; a random
    # initial state with a stride-0 u
    H3, T3 = 40, LM_PATHS[1].seq - 1
    cases.append(scan_case(LM_CHUNK * LM_BATCH * H3, T3, 64, 64, 32, H3,
                           True, primary=True, seed=130, with_serial=True))
    cases.append(scan_case(LM_BATCH * H3, T3, 64, 64, 32, H3, True,
                           primary=False, seed=131, timed=True,
                           with_serial=True))
    for i, (T, K, V, chunk) in enumerate(((32, 8, 8, 8), (64, 16, 32, 16),
                                          (64, 8, 16, 32))):
        cases.append(scan_case(4, T, K, V, chunk, 0, False, primary=False,
                               seed=132 + i))
    cases.append(scan_case(6, 17, 16, 16, 17, 2, False, primary=False,
                           seed=135))
    # K and V not multiples of 4: route C's 4-byte copies instead of TMA
    cases.append(scan_case(3, 40, 5, 7, 8, 0, False, primary=False,
                           seed=138))
    cases.append(scan_case(64, 96, 64, 64, 32, 1, False, primary=False,
                           seed=136, timed=True, with_serial=True))
    # strong decay at the un-stacked path shape: the plain version is not
    # finite there, route C is held to the float64 token loop and route S
    cases.append(scan_case(LM_BATCH * H3, T3, 64, 64, 32, H3, True,
                           primary=False, seed=137, strong=True))
    # the serving prefill of one request: 20 tokens, not a multiple of
    # route C's 16-token chunk, from a random state per row (the cache's),
    # with the (H, K) table
    cases.append(scan_case(H3, RWKV_SERVE_PROMPT, 64, 64, RWKV_SERVE_PROMPT,
                           H3, False, primary=False, seed=139, timed=True,
                           with_serial=True))

    # ---- rwkv6_scan_bwd: kernel 7's primary shape, and the family sweep's
    # training shape (a batch of FAMILY_TRAIN_BATCH x 40 heads of
    # FAMILY_TRAIN_SEQ tokens), as the time-mix calls it: the (H, K) table,
    # a stride-0 zero state, no final-state gradient; then strong decay, and
    # ragged shapes with a random state, a final-state gradient and ds0
    cases.append(scan_bwd_case(LM_CHUNK * LM_BATCH * H3, T3, 64, 64, H3,
                               True, False, primary=True, seed=230))
    train_bh = FAMILY_TRAIN_BATCH * H3
    cases.append(scan_bwd_case(train_bh, FAMILY_TRAIN_SEQ, 64, 64, H3, True,
                               False, primary=False, seed=231, timed=True))
    cases.append(scan_bwd_case(train_bh, FAMILY_TRAIN_SEQ, 64, 64, H3, True,
                               False, primary=False, seed=232, strong=True))
    for i, (bh, T, K, V, heads) in enumerate(((6, 13, 5, 7, 0),
                                              (12, 40, 64, 33, 3),
                                              (4, 8, 64, 64, 1))):
        cases.append(scan_bwd_case(bh, T, K, V, heads, False, True,
                                   primary=False, seed=233 + i))
    return cases


# -------------------------------------------------------------- main path


def make_model_and_batch(seed: int):
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.models.resnet import CNN, CNNConfig
    model = CNN(CNNConfig.resnet18(10, 32))
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen, "cuda")
    data = SyntheticImages(ImageDatasetCfg.cifar10(seed=seed))
    batch = data.train_eval_set(128)
    return model, params, batch


def run_forward(model, params, batch, seed: int):
    """Un-stacked unfused vs fused, stacked vs un-stacked, card vs CPU."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    rng = np.random.default_rng(seed)
    sites = model.mask_sites()
    trees = [{k: (rng.random(s.shape) < 0.6).astype(np.float32)
              for k, s in sites.items()} for _ in range(2)]
    images = to_device(batch["images"], "cuda")
    with torch.no_grad():
        dev = [M.as_device(t, "cuda") for t in trees]
        plain = [model.forward(params, d, images, ties=False) for d in dev]
        fused = [model.forward(params, d, images, fused=True, ties=False)
                 for d in dev]
        stacked = M.as_device(M.stack_trees(trees), "cuda")
        st_plain = model.forward(params, stacked, images, ties=False)
        pre = model.forward_pre(params, images)
        st_fused = model.forward(params, stacked, images, pre=pre,
                                 fused=True, ties=False)
        # the same network on the CPU (plain versions), 8 images
        small = images[:8]
        cpu_params = to_device(params, "cpu")
        want = model.forward(cpu_params, M.as_device(trees[0], "cpu"),
                             small.cpu(), ties=False)
        got = model.forward(params, dev[0], small, fused=True, ties=False)
    torch.cuda.synchronize()
    if plain[0].shape != (128, 10) or st_plain.shape != (2, 128, 10):
        fail(f"forward: logits shapes {plain[0].shape} {st_plain.shape}")
    diffs = {
        "fused_vs_unfused": max(float((a - b).abs().max())
                                for a, b in zip(plain, fused)),
        "stacked_vs_unstacked": max(float((st_plain[i] - plain[i]).abs()
                                          .max()) for i in range(2)),
        "stacked_fused_pre_vs_unstacked": max(
            float((st_fused[i] - plain[i]).abs().max()) for i in range(2)),
        "card_vs_cpu_8_images": float((got.cpu() - want).abs().max()),
    }
    for t in plain + fused + [st_plain, st_fused, got]:
        if not torch.isfinite(t).all():
            fail("forward: non-finite logits")
    for k, v in diffs.items():
        if not v <= LOGIT_TOL:
            fail(f"forward: {k} = {v} exceeds {LOGIT_TOL}")
    top2 = plain[0].topk(2, dim=-1).values
    return dict(batch=128, relus=model.relu_count(), sites=len(sites),
                mask_density=0.6, logit_tol=LOGIT_TOL, max_abs_diff=diffs,
                min_top2_margin=float((top2[:, 0] - top2[:, 1]).min()),
                relu_kept=M.count(trees[0]))


def run_bcd_phase(model, params, batch, steps: int):
    from repro_torch.core import bcd, linearize, masks as M
    from repro_torch.kernels import build
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    total = model.relu_count()
    rt, chunk, drc = 16, 8, 100
    runs = []
    # the paper's plain removal moves with and without the ADT early exit,
    # then a move set with stage-local macro-moves, whose candidates cut
    # deep enough for the suffix engine to go site-aware (uniform removals
    # from full masks touch the first sites in every candidate, so those
    # chunks take its full-forward fallback)
    for adt, moves in ((0.3, ("remove",)), (-100.0, ("remove",)),
                       (-100.0, ("remove", "stage_drop"))):
        prints = {}
        for backend in ("sequential", "batched", "pipelined", "suffix"):
            holder = {"params": params}
            evaluator, eval_acc, _ = make_bcd_evaluator(
                backend, model, batch, holder, chunk_size=chunk, rt=rt,
                prefetch=2, fused_kernels=True, device="cuda")
            cfg = bcd.BCDConfig(b_target=total - drc * steps, drc=drc, rt=rt,
                                adt=adt, finetune_every_step=False, seed=0,
                                chunk_size=chunk, moves=moves)
            before = dict(build.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bcd.run_bcd(masks0, cfg, eval_acc, evaluator=evaluator)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: build.launch_counts[k] - before[k]
                        for k in build.launch_counts}
            if M.relu_cost(res.masks) != total - drc * steps:
                fail(f"bcd {backend}: budget {M.relu_cost(res.masks)}")
            accs = [h.acc_before for h in res.history]
            if not all(np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs):
                fail(f"bcd {backend}: accuracies {accs}")
            trials = sum(h.trials for h in res.history)
            prints[backend] = M.fingerprint(res.masks)
            run = dict(backend=backend, adt=adt, moves=list(moves),
                       steps=len(res.history),
                       trials=trials, wall_s=wall,
                       # candidate forwards the engine was asked for, plus
                       # one base-accuracy forward per step, per second
                       candidates_per_s=(trials + len(res.history)) / wall,
                       fingerprint=prints[backend][:16],
                       best_drops=[h.best_drop for h in res.history],
                       acc_before=accs, launches=launches)
            trie = getattr(evaluator, "trie", None)
            if trie is not None:
                run["trie"] = dict(hits=trie.hits,
                                   extensions=trie.extensions,
                                   misses=trie.misses,
                                   evictions=trie.evictions)
                if "stage_drop" in moves and not (
                        trie.misses + trie.extensions > 0 and
                        launches["masked_act_conv3x3_batched"] > 0):
                    fail(f"bcd suffix {moves}: no sited chunk was evaluated "
                         f"(trie {run['trie']}, launches {launches})")
            runs.append(run)
        if len(set(prints.values())) != 1:
            fail(f"bcd adt={adt} moves={moves}: engines selected different "
                 f"blocks: {prints}")
    return dict(model="resnet18", batch=128, drc=drc, rt=rt,
                chunk_size=chunk, steps=steps, runs=runs)


def run_sited_phase(model, params, batch):
    """Site-local candidates at two depths through the batched engine and
    the suffix engine (unfused and fused): equal accuracies, and the rates
    the prefix reuse and the fused kernels are there for."""
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.kernels import build
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    fractions = model.site_prefix_fractions()
    rng = np.random.default_rng(0)
    reps, out = 3, []
    for site in ("g1b0.relu1", "g3b0.relu1"):
        idx = M.sample_removal_indices_within(rng, masks0, 100, 16, [site])
        chunks = [M.materialize_candidates(masks0, idx[i:i + 8])
                  for i in (0, 8)]
        accs, row = {}, dict(site=site, prefix_fraction=fractions[site],
                             candidates=16, chunk_size=8)
        for label, backend, fused in (("batched", "batched", False),
                                      ("suffix_unfused", "suffix", False),
                                      ("suffix_fused", "suffix", True)):
            ev, _, _ = make_bcd_evaluator(
                backend, model, batch, {"params": params}, chunk_size=8,
                rt=16, prefetch=0, fused_kernels=fused, device="cuda")
            items = chunks
            if backend == "suffix":
                ev.begin_step(masks0)
                items = [E.SitedChunk(site, c) for c in chunks]
            before = dict(build.launch_counts)
            accs[label] = np.concatenate([ev.evaluate(it) for it in items])
            launches = {k: build.launch_counts[k] - before[k]
                        for k in build.launch_counts}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                for it in items:
                    ev.evaluate(it)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row[label] = dict(candidates_per_s=reps * 16 / wall,
                              launches_first_pass=launches)
            if backend == "suffix":
                row[label]["trie"] = dict(hits=ev.trie.hits,
                                          extensions=ev.trie.extensions,
                                          misses=ev.trie.misses)
        for label, a in accs.items():
            if not np.array_equal(a, accs["batched"]):
                fail(f"sited {site}: {label} accuracies {a} differ from "
                     f"batched {accs['batched']}")
        row["accs"] = [float(a) for a in accs["batched"]]
        out.append(row)
    return dict(model="resnet18", batch=128, timed_passes=reps, rows=out)


# ------------------------------------------------------------ training half


class record_gate_signs:
    """Within the block, every gate records the signs of its input
    (``CNN._relu`` calls ``linearize.apply_masked_act``): where the card
    and the CPU give a ReLU's input different signs, the gradient takes
    another branch of the kink."""

    def __init__(self):
        self.signs = {}

    def __enter__(self):
        from repro_torch.core import linearize
        self.orig = linearize.apply_masked_act

        def wrapped(x, mask, site, *a, **kw):
            # by site shape, in call order (sites of one shape share a key)
            name = "x".join(map(str, site.shape))
            self.signs.setdefault(name, []).append(
                torch.sign(x.detach()).to(torch.int8).cpu())
            return self.orig(x, mask, site, *a, **kw)
        linearize.apply_masked_act = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import linearize
        linearize.apply_masked_act = self.orig


class forced_plain_bwd:
    """Within the block the gate's backward on the card is the plain
    version (``ref.masked_act_bwd_ref``) instead of ``gate_bwd_kernel``;
    chip_smoke.py holds one train step's gradients through the kernel to
    it.  The port itself never swaps it."""

    def __enter__(self):
        from repro_torch.kernels import masked_act as K, ref
        self.orig = K.masked_act_2d_bwd

        def plain(x, mask, g, poly=None, *, kind="relu", need_dpoly=False):
            return ref.masked_act_bwd_ref(x, mask, g, kind, poly, need_dpoly)
        K.masked_act_2d_bwd = plain

    def __exit__(self, *exc):
        from repro_torch.kernels import masked_act as K
        K.masked_act_2d_bwd = self.orig


def grad_check(model, params, masks, bn, device="cuda"):
    """One train step's gradients from the same parameters, masks and
    batch of 32: on the card through ``gate_bwd_kernel``, on the card
    through the plain backward, and on the CPU.  Every leaf's gradient on
    the card must be finite and not all zero; through the kernel it must
    equal the plain backward's within ``KERNEL_STEP_TOL`` of the leaf's
    largest entry; against the CPU's, each leaf's relative L2 error is
    reported with the ReLU inputs whose sign differs between card and
    CPU."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    from repro_torch.kernels import build
    from repro_torch.training import optimizer as opt_lib, train
    _, loss_fn = train.make_cnn_train_step(model, opt_lib.sgd(5e-2))
    m_dev, b_dev = M.as_device(masks, device), to_device(bn(0), device)
    before = build.launch_counts["masked_act_2d_bwd"]
    with record_gate_signs() as rec_c, train.deterministic():
        (loss_c, _), g_card = train.loss_and_grads(loss_fn, params, m_dev,
                                                   b_dev)
    sync(device)
    bwd_launches = build.launch_counts["masked_act_2d_bwd"] - before
    with forced_plain_bwd(), train.deterministic():
        _, g_plain = train.loss_and_grads(loss_fn, params, m_dev, b_dev)
    with record_gate_signs() as rec_h:
        (loss_h, _), g_cpu = train.loss_and_grads(
            loss_fn, to_device(params, "cpu"), M.as_device(masks, "cpu"),
            to_device(bn(0), "cpu"))
    names = opt_lib.tree_leaves(_leaf_names(params))
    leaves = zip(names, opt_lib.tree_leaves(g_card),
                 opt_lib.tree_leaves(g_plain), opt_lib.tree_leaves(g_cpu))
    per_leaf, kernel_vs_plain = {}, (-1.0, "")
    for name, gc, gp, gh in leaves:
        if not bool(torch.isfinite(gc).all()) or not bool(gc.abs().max() > 0):
            fail(f"train: the card's gradient of {name} is not finite or "
                 "all zero")
        rel = float((gc - gp).abs().max() / gp.abs().max())
        kernel_vs_plain = max(kernel_vs_plain, (rel, name))
        gc = gc.cpu()
        per_leaf[name] = dict(
            max_rel=float((gc - gh).abs().max() / gh.abs().max()),
            l2_rel=float((gc - gh).norm() / gh.norm()))
    if not kernel_vs_plain[0] <= KERNEL_STEP_TOL:
        fail(f"train: the step's gradient of {kernel_vs_plain[1]} through "
             f"the backward kernel differs from the plain backward's by "
             f"{kernel_vs_plain[0]} of its largest entry")
    if device != "cpu" and bwd_launches != len(masks):
        fail(f"train: {bwd_launches} launches of the gate's backward for "
             f"{len(masks)} sites")
    flips = {k: int(sum(int((a != b).sum()) for a, b in zip(
        rec_c.signs[k], rec_h.signs[k]))) for k in rec_c.signs}
    worst_l2 = max((v["l2_rel"], k) for k, v in per_leaf.items())
    worst_max = max((v["max_rel"], k) for k, v in per_leaf.items())
    if not worst_l2[0] <= GRAD_TOL:
        fail(f"train: card vs CPU gradient of {worst_l2[1]}: relative L2 "
             f"error {worst_l2[0]} exceeds {GRAD_TOL} (ReLU sign flips "
             f"{flips})")
    return dict(leaves=len(per_leaf),
                kernel_vs_plain_bwd=dict(max_rel=kernel_vs_plain[0],
                                         leaf=kernel_vs_plain[1],
                                         tol=KERNEL_STEP_TOL),
                card_vs_cpu=dict(l2_tol=GRAD_TOL, worst_l2_rel=worst_l2,
                                 worst_max_rel=worst_max,
                                 relu_sign_flips_by_site=flips,
                                 per_leaf=per_leaf),
                loss_card=float(loss_c), loss_cpu=float(loss_h),
                bwd_launches_per_step=bwd_launches)


def _leaf_names(tree, prefix=""):
    """The tree with each leaf replaced by its dotted path (a str leaf)."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v, f"{prefix}{k}.") for k, v in tree.items()}
    return prefix[:-1]


def time_train_steps(step, params, opt, masks_dev, batches, device):
    """Wall-clock ms per train step over ``TRAIN_TIMED`` steps after two
    warm-up steps (a fresh optimizer state each time)."""
    ostate = opt.init(params)
    p = params
    for i in range(2):
        p, ostate, _, _ = step(p, ostate, masks_dev, batches(i))
    sync(device)
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        p, ostate, _, _ = step(p, ostate, masks_dev, batches(2 + i))
    sync(device)
    return (time.perf_counter() - t0) / TRAIN_TIMED * 1e3


def device_families(prof, n: int):
    """Device milliseconds per window step by kernel family, and kernel
    launches per step, from a finished ``torch.profiler`` window of ``n``
    steps."""
    fams = {"gate_bwd_kernel": 0.0, "gate_kernel": 0.0, "rwkv6_scan": 0.0,
            "rwkv6_scan_bwd": 0.0,
            "conv": 0.0, "gemm": 0.0, "reduce": 0.0, "elementwise": 0.0,
            "copy": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or str(getattr(e, "device_type", "")).find("CUDA") < 0:
            continue
        launches += e.count
        k = e.key
        low = k.lower()
        if "gate_bwd_kernel" in k or "poly_reduce_kernel" in k:
            fam = "gate_bwd_kernel"
        elif "gate_kernel" in k:
            fam = "gate_kernel"
        elif "rwkv6_scan_bwd" in k or "rwkv6_du_reduce" in k:
            fam = "rwkv6_scan_bwd"
        elif "rwkv6_scan" in k:
            fam = "rwkv6_scan"
        elif any(t in low for t in ("conv", "cudnn", "wgrad", "dgrad",
                                     "implicit", "winograd", "fft")):
            fam = "conv"
        elif any(t in low for t in ("gemm", "sgemm", "cutlass", "cublas")):
            fam = "gemm"
        elif "reduce" in low:
            fam = "reduce"
        elif "elementwise" in low or "vectorized" in low:
            fam = "elementwise"
        elif "copy" in low or "memcpy" in low or "memset" in low:
            fam = "copy"
        else:
            fam = "other"
        fams[fam] += us / 1e3 / n
    return fams, launches / n


def profile_window(fn, n: int):
    """Device time of ``n`` calls of ``fn`` by kernel family, kernel
    launches a call, and the device's busy share of the wall-clock, from
    ``torch.profiler`` (None where it records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(1 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams, launches = device_families(prof, n)
    busy = sum(fams.values())
    if busy <= 0.0:
        return None
    return dict(steps=n, wall_ms_per_step=wall / n * 1e3,
                device_ms_per_step_by_family=fams,
                device_busy_ms_per_step=busy,
                device_busy_share=busy / (wall / n * 1e3),
                kernel_launches_per_step=launches)


def profile_train_steps(step, params, opt, masks_dev, batches, n=3):
    """Device time of ``n`` train steps by kernel family, kernel launches a
    step, and the device's busy share of the wall-clock
    (:func:`profile_window`)."""
    state = {"p": params, "o": opt.init(params)}

    def one(i):
        state["p"], state["o"], _, _ = step(state["p"], state["o"],
                                            masks_dev, batches(i))
    return profile_window(one, n)


def run_train_path(by_path, device="cuda", cfg=None):
    """The paper's training half at ResNet18's full width: the card-vs-CPU
    gradient check, the step's time with and without deterministic
    algorithms, then train_base → SNL → finetune (twice, bit-identical) →
    BCD with finetuning between steps through the batched and suffix
    engines (identical blocks and parameters).  Counts set to 0 just
    before, read just after.  ``device="cpu"`` with a reduced ``cfg``
    rehearses the path on a machine without a card."""
    from repro_torch.convert import to_device
    from repro_torch.core import bcd, linearize, masks as M
    from repro_torch.core.snl import SNLConfig, finetune, run_snl
    from repro_torch.data import ImageDatasetCfg, SyntheticImages
    from repro_torch.kernels import build
    from repro_torch.launch.sweep import make_bcd_evaluator
    from repro_torch.models.resnet import CNN, CNNConfig
    from repro_torch.training import optimizer as opt_lib, train
    model = CNN(cfg or CNNConfig.resnet18(10, 32))
    data = SyntheticImages(ImageDatasetCfg(
        n_classes=model.cfg.n_classes, image_size=model.cfg.image_size,
        seed=SEED))
    params0 = model.init(torch.Generator().manual_seed(SEED), device)
    bn = data.batches("train", TRAIN_BATCH)

    def batches(i):
        return to_device(bn(i), device)
    sites = model.mask_sites()
    masks0 = linearize.init_masks(sites)
    total = model.relu_count()
    b_ref = int(0.6 * total)
    rng = np.random.default_rng(SEED)
    rand_masks = {k: (rng.random(s.shape) < 0.6).astype(np.float32)
                  for k, s in sites.items()}
    eval_b = data.train_eval_set(128)
    test_b = to_device(data.eval_set(64), device)
    test_acc_fn = train.make_eval_acc(
        lambda p, m: model.forward(p, M.as_device(m, device),
                                   test_b["images"]), test_b)

    def sloss(p, a, batch, soft):
        logits = model.forward(p, a, batch["images"], soft=soft)
        return train.cross_entropy(logits, batch["labels"]), 0.0

    build.reset_launch_counts()
    grads = grad_check(model, params0, rand_masks, bn, device)

    # ---- the step: time with and without deterministic algorithms
    opt = opt_lib.sgd(lr=5e-2, momentum=0.9)
    step, _ = train.make_cnn_train_step(model, opt)
    step_nd, _ = train.make_cnn_train_step(
        model, opt, deterministic_algorithms=False)
    mdev = M.as_device(masks0, device)
    times = {"deterministic": [], "not_deterministic": []}
    for label, fn in (("deterministic", step), ("not_deterministic", step_nd),
                      ("not_deterministic", step_nd),
                      ("deterministic", step)):
        if label == "not_deterministic":
            torch.backends.cudnn.benchmark = True
        times[label].append(time_train_steps(fn, params0, opt, mdev,
                                             batches, device))
        torch.backends.cudnn.benchmark = False
    prof = None if device == "cpu" else profile_train_steps(
        step, params0, opt, mdev, batches)
    ms = min(times["deterministic"])

    # ---- train_base
    stages = {}
    ostate = opt.init(params0)
    params = params0
    losses = []
    sync(device)
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        params, ostate, loss, _ = step(params, ostate, mdev, batches(i))
        losses.append(loss)
    sync(device)
    stages["train_base"] = _stage(time.perf_counter() - t0, TRAIN_STEPS)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: train_base's loss did not fall: {losses}")

    # ---- SNL to B_ref, then the finetune twice
    alphas = {k: np.ones(v.shape, np.float32) for k, v in masks0.items()}
    sync(device)
    t0 = time.perf_counter()
    res = run_snl(params, alphas, sloss, batches,
                  SNLConfig(b_target=b_ref, lam0=5e-4, kappa=1.5,
                            epochs=SNL_EPOCHS, steps_per_epoch=SNL_STEPS,
                            lr=3e-2, finetune_steps=FT_STEPS),
                  device=device)
    sync(device)
    stages["snl"] = _stage(time.perf_counter() - t0,
                           len(res.budget_per_epoch) * SNL_STEPS + FT_STEPS)
    if M.count(res.masks) != b_ref:
        fail(f"snl: {M.count(res.masks)} ReLUs kept, B_ref is {b_ref}")
    ft = []
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        ft.append(finetune(res.params, res.masks, sloss, batches,
                           steps=FT_STEPS, lr=1e-2, device=device))
        sync(device)
        stages.setdefault("finetune", []).append(
            _stage(time.perf_counter() - t0, FT_STEPS))
    same = all(torch.equal(a, b) for a, b in zip(
        opt_lib.tree_leaves(ft[0]), opt_lib.tree_leaves(ft[1])))
    if not same:
        fail("snl: a finetune repeated from the same parameters and "
             "batches gave other bits")
    snl_line = dict(
        b_ref=b_ref, relus=total, epochs=SNL_EPOCHS,
        steps_per_epoch=SNL_STEPS, finetune_steps=FT_STEPS,
        budget_per_epoch=res.budget_per_epoch,
        lam_per_epoch=res.lam_per_epoch,
        alpha_min=float(min(v.min() for v in res.alphas.values())),
        alpha_mean=float(np.mean(np.concatenate(
            [v.ravel() for v in res.alphas.values()]))),
        finetune_repeat_bit_identical=same,
        test_acc_at_b_ref=float(test_acc_fn(ft[0], res.masks)))

    # ---- BCD from B_ref with finetuning between steps, two engines
    drc, rt, chunk = 100, 16, 8
    runs, prints, finals = [], {}, {}
    for engine in ("batched", "suffix"):
        holder = {"params": res.params}
        evaluator, eval_acc, set_ctx = make_bcd_evaluator(
            engine, model, eval_b, holder, chunk_size=chunk, rt=rt,
            prefetch=2, fused_kernels=True, device=device)

        def ft_cb(m, holder=holder, set_ctx=set_ctx):
            holder["params"] = finetune(holder["params"], m, sloss, batches,
                                        steps=FT_STEPS, lr=1e-2,
                                        device=device)
            set_ctx(holder["params"])
        # no early exit: every trial of a step goes through the engine
        cfg = bcd.BCDConfig(b_target=b_ref - drc * TRAIN_BCD_STEPS, drc=drc,
                            rt=rt, adt=-100.0, seed=0, chunk_size=chunk)
        sync(device)
        t0 = time.perf_counter()
        out = bcd.run_bcd(res.masks, cfg, eval_acc, finetune=ft_cb,
                          evaluator=evaluator)
        sync(device)
        wall = time.perf_counter() - t0
        if M.relu_cost(out.masks) != cfg.b_target:
            fail(f"pipeline {engine}: budget {M.relu_cost(out.masks)}")
        prints[engine] = M.fingerprint(out.masks)
        finals[engine] = holder["params"]
        runs.append(dict(
            engine=engine, steps=len(out.history),
            trials=sum(h.trials for h in out.history), wall_s=wall,
            fingerprint=prints[engine][:16],
            acc_before=[h.acc_before for h in out.history],
            acc_after_finetune=[h.acc_after_finetune for h in out.history],
            test_acc=float(test_acc_fn(holder["params"], out.masks))))
    if len(set(prints.values())) != 1:
        fail(f"pipeline: the engines selected different blocks after "
             f"finetuning: {prints}")
    if not all(torch.equal(a, b) for a, b in zip(
            opt_lib.tree_leaves(finals["batched"]),
            opt_lib.tree_leaves(finals["suffix"]))):
        fail("pipeline: the engines' finetuned parameters differ")
    by_path["resnet18_train"] = counts()

    ms_nd = min(times["not_deterministic"])
    train_line = dict(
        model=model.cfg.name, batch=TRAIN_BATCH, relus=total,
        cuts={"train_base_steps": [TRAIN_STEPS, 80],
              "snl_epochs_x_steps": [[SNL_EPOCHS, SNL_STEPS], [6, 5]],
              "finetune_steps": [FT_STEPS, "15 (SNL), 12 (BCD)"],
              "bcd_steps": TRAIN_BCD_STEPS,
              "note": "cuts of the schedule, not of the model; "
                      "[this run, the example]"},
        card_vs_cpu=grads,
        step_ms={"deterministic": ms, "not_deterministic": ms_nd,
                 "runs": times, "determinism_cost": ms / ms_nd - 1.0},
        images_per_s=TRAIN_BATCH / ms * 1e3,
        profile=prof,
        train_base=dict(stages["train_base"], loss_first=losses[0],
                        loss_last=losses[-1]))
    pipeline_line = dict(
        stages={"train_base": stages["train_base"], "snl": stages["snl"],
                "finetune": stages["finetune"],
                "bcd": {r["engine"]: r["wall_s"] for r in runs}},
        bcd=dict(b_ref=b_ref, b_target=b_ref - drc * TRAIN_BCD_STEPS,
                 drc=drc, rt=rt, adt=-100.0, chunk_size=chunk,
                 finetune_steps=FT_STEPS, runs=runs),
        engines_identical=True)
    return train_line, snl_line, pipeline_line


def _stage(seconds, steps):
    return dict(wall_s=seconds, steps=steps,
                images_per_s=steps * TRAIN_BATCH / seconds)


# ------------------------------------------------------- resumable sweeps


EXAMPLE = os.path.join(HERE, "examples", "torch_resnet18_bcd_pipeline.py")


def load_example():
    """``examples/torch_resnet18_bcd_pipeline.py`` as a module: the sweep
    path runs through the entry point a user calls."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_pipeline_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class checkpoint_costs:
    """Within the block, every checkpoint ``save``, deep ``validate`` and
    ``restore`` of ``repro_torch.training.checkpoint`` is timed (the card
    synchronised first, so queued work is not billed to the copy) and each
    save's bytes on disk are summed.  Measurement only: the functions are
    put back on exit."""

    NAMES = ("save", "validate", "restore")

    def __init__(self, device):
        self.device = device
        self.calls = []

    def __enter__(self):
        from repro_torch.training import checkpoint as ck
        self._ck = ck
        self._orig = {n: getattr(ck, n) for n in self.NAMES}
        for name in self.NAMES:
            setattr(ck, name, self._timed(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._ck, name, fn)

    def _timed(self, name, fn):
        def wrapper(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            if name == "save":          # save(state, ckpt_dir, step) -> dir
                self.calls.append(dict(
                    op=name, ms=ms, dir=out,
                    bytes=sum(os.path.getsize(os.path.join(out, f))
                              for f in os.listdir(out))))
            elif name == "restore" or kw.get("deep"):
                # restore(template, ckpt_dir, step), validate(ckpt_dir, step)
                ckpt_dir, step = a[-2:] if name == "restore" else a[:2]
                self.calls.append(dict(op=name, ms=ms, dir=os.path.join(
                    ckpt_dir, f"step_{step:08d}")))
            return out
        return wrapper

    def summary(self, op, kind):
        """Count, mean / min / max ms (and bytes for saves) of ``op`` on
        runner checkpoints (``kind="runner"``, ``…/ckpt/step_*``) or stage
        inits (``kind="stage_init"``)."""
        rows = [c for c in self.calls if c["op"] == op and
                (os.path.basename(os.path.dirname(c["dir"])) == "ckpt")
                == (kind == "runner")]
        if not rows:
            return None
        ms = [c["ms"] for c in rows]
        out = dict(n=len(rows), mean_ms=float(np.mean(ms)),
                   min_ms=min(ms), max_ms=max(ms))
        if op == "save":
            out["bytes"] = sorted({c["bytes"] for c in rows})
        return out


def _stage_identity(stage):
    """A stage of a sweep artifact without its wall-clock and resume
    point: what every run of one schedule must agree on."""
    return {k: v for k, v in stage.items()
            if k not in ("wall_s", "resumed_from")}


def _child(cmd, env, timeout):
    """Run one process of the example; its exit code, output and
    wall-clock.  A child past its time limit is killed and fails the
    phase."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"sweep: {' '.join(cmd[1:])} ran past {timeout} s")
    return out, time.perf_counter() - t0


def _save_share(costs, run_dir, budgets, stages):
    """Each stage's runner-checkpoint saves (``costs``) as a share of the
    stage's wall-clock."""
    out = []
    for i, (b, stage) in enumerate(zip(budgets, stages)):
        ck = os.path.join(run_dir, f"stage_{i:02d}_b{b}", "ckpt")
        ms = sum(c["ms"] for c in costs.calls
                 if c["op"] == "save" and c["dir"].startswith(ck))
        out.append(ms / 1e3 / stage["wall_s"])
    return out


def run_sweep_path(by_path, device="cuda", flags=SWEEP_FLAGS,
                   schedule=SWEEP_SCHEDULE,
                   default_schedule=SWEEP_DEFAULT_SCHEDULE):
    """The resumable budget sweep through the example's ``--sweep`` mode,
    at ResNet18's full width on the card (``flags``):

      1. train + SNL once (the training path's cuts), the warm start
         persisted to ``init/`` and copied into every run directory;
      2. the sweep, serially, in this process;
      3. the same sweep with ``--overlap``, in this process;
      4. a child process killed by ``REPRO_KILL_AFTER_STEPS`` after stage
         0 and one block of stage 1, then a child that resumes it;
      5. two ranks on the one card (``REPRO_COORD_RANK`` 0/1, world 2),
         stage 0 only, sharing one directory;
      6. ``default_schedule``, serially in this process: launches by
         kernel and checkpoint costs at the example's own block size.

    Counts are set to 0 just before steps 2–3 and read just after (and
    again around step 6, which is read apart).  Fails
    unless every run gives the same stages (fingerprints, histories,
    scores), bit-equal final parameters and complete artifacts, and the
    resumed run records where it resumed.  Run directories live under a
    temporary directory, removed at the end.  ``device="cpu"`` with mini
    ``flags`` rehearses the path without a card."""
    import contextlib
    import io
    import math
    import shutil
    import tempfile
    from repro_torch.core import bcd, linearize, masks as M, runner
    from repro_torch.core.snl import SNLConfig, run_snl
    from repro_torch.kernels import build
    from repro_torch.training import checkpoint, optimizer as opt_lib
    ex = load_example()
    flags = list(flags) + ["--device", device]
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        dirs = {k: os.path.join(root, k)
                for k in ("serial", "overlap", "killed", "ranks",
                          "default")}
        args = ex.parse_args(flags + ["--sweep", schedule,
                                      "--out-dir", dirs["serial"]])

        # ---- 1. the warm start, once
        model, data = ex.build_model_data(args)
        opt, step, batches, sloss, _ = ex.make_closures(model, data, device)
        masks0 = linearize.init_masks(model.mask_sites())
        total = M.count(masks0)
        b_ref = int(total * args.ref_frac)
        budgets = [int(total * f) for f in args.sweep]
        drc = ex.sweep_drc(b_ref, budgets)
        steps = [math.ceil((a - b) / drc)
                 for a, b in zip([b_ref] + budgets, budgets)]
        if not all(2 <= n <= 4 for n in steps):
            fail(f"sweep: stages of {steps} blocks; the phase needs 2-4")
        sync(device)
        t0 = time.perf_counter()
        params = model.init(torch.Generator().manual_seed(SEED), device)
        ostate = opt.init(params)
        mdev = M.as_device(masks0, device)
        for i in range(TRAIN_STEPS):
            params, ostate, _, _ = step(params, ostate, mdev, batches(i))
        alphas = {k: np.ones(v.shape, np.float32) for k, v in masks0.items()}
        res = run_snl(params, alphas, sloss, batches,
                      SNLConfig(b_target=b_ref, lam0=5e-4, kappa=1.5,
                                epochs=SNL_EPOCHS, steps_per_epoch=SNL_STEPS,
                                lr=3e-2, finetune_steps=FT_STEPS),
                      device=device)
        init = os.path.join(root, "init")
        runner.save_stage_init(init, res.stage_init())
        sync(device)
        warm_s = time.perf_counter() - t0
        for d in dirs.values():
            shutil.copytree(init, os.path.join(d, "init"))
        del params, ostate, res

        # ---- 2, 3. serial and overlapped, counted and timed in-process
        walls, logs = {}, io.StringIO()
        build.reset_launch_counts()
        with checkpoint_costs(device) as costs:
            for name, extra in (("serial", []), ("overlap", ["--overlap"])):
                sync(device)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(logs):
                    ex.run_sweep_mode(ex.parse_args(
                        flags + ["--sweep", schedule, "--out-dir",
                                 dirs[name]] + extra))
                sync(device)
                walls[name] = time.perf_counter() - t0
        by_path["resnet18_sweep"] = counts()

        # ---- 4, 5. children: killed + resumed, then two ranks
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("REPRO_COORD_") and k != runner.KILL_ENV}
        cmd = [sys.executable, EXAMPLE] + flags + ["--sweep", schedule,
                                                   "--out-dir",
                                                   dirs["killed"]]
        kill_after = steps[0] + 1          # stage 1's first block
        killed, walls["killed"] = _child(
            cmd, dict(env, **{runner.KILL_ENV: str(kill_after)}),
            SWEEP_CHILD_TIMEOUT_S)
        if killed.returncode != -9:
            fail(f"sweep: the killed child exited {killed.returncode}, not "
                 f"by SIGKILL: {killed.stderr[-2000:]}")
        resumed, walls["resumed"] = _child(cmd, env, SWEEP_CHILD_TIMEOUT_S)
        if resumed.returncode != 0:
            fail(f"sweep: the resumed child exited {resumed.returncode}: "
                 f"{resumed.stderr[-2000:]}")
        stage0 = schedule.split(",")[0]
        rank_cmd = [sys.executable, EXAMPLE] + flags + [
            "--sweep", stage0, "--out-dir", dirs["ranks"]]
        procs = []
        t0 = time.perf_counter()
        for r in range(2):
            procs.append(subprocess.Popen(
                rank_cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(env, REPRO_COORD_RANK=str(r),
                                    REPRO_COORD_WORLD="2",
                                    REPRO_COORD_DIR=os.path.join(root,
                                                                 "coord"),
                                    REPRO_COORD_SESSION="chip_smoke",
                                    REPRO_COORD_TIMEOUT_S="120")))
        try:
            outs = [p.communicate(timeout=SWEEP_CHILD_TIMEOUT_S)
                    for p in procs]
        except subprocess.TimeoutExpired:
            fail(f"sweep: a rank ran past {SWEEP_CHILD_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        walls["ranks"] = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"sweep: rank {r} exited {p.returncode}: {err[-2000:]}")

        # ---- what every run must agree on
        # ---- 6. the example's own schedule, read apart
        build.reset_launch_counts()
        with checkpoint_costs(device) as dcosts:
            sync(device)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(logs):
                ex.run_sweep_mode(ex.parse_args(
                    flags + ["--sweep", default_schedule, "--out-dir",
                             dirs["default"]]))
            sync(device)
            walls["default"] = time.perf_counter() - t0
        default_counts = counts()

        arts = {k: json.load(open(os.path.join(
            d, f"SWEEP_{model.cfg.name}.json"))) for k, d in dirs.items()}
        for k, a in arts.items():
            if not a["complete"]:
                fail(f"sweep: the {k} run's artifact is not complete")
        want = [_stage_identity(s) for s in arts["serial"]["stages"]]
        if [s["steps"] for s in want] != steps:
            fail(f"sweep: stages of {[s['steps'] for s in want]} blocks, "
                 f"expected {steps}")
        dflt = arts.pop("default")
        for k in ("overlap", "killed", "ranks"):
            got = [_stage_identity(s) for s in arts[k]["stages"]]
            if got != want[:len(got)]:
                fail(f"sweep: the {k} run's stages differ from the serial "
                     f"run's: {got} vs {want}")
        resumed_from = arts["killed"]["stages"][1]["resumed_from"]
        if resumed_from is None or \
                arts["serial"]["stages"][1]["resumed_from"] is not None:
            fail("sweep: the resumed run records no resume point")
        template = model.init(torch.Generator().manual_seed(SEED), device)
        finals = {}
        for k, a in arts.items():
            for i, b in enumerate(budgets[:len(a["stages"])]):
                finals[k, i] = opt_lib.tree_leaves(runner.load_stage_init(
                    os.path.join(dirs[k], f"stage_{i:02d}_b{b}", "final"),
                    masks0,
                    params_template=template, device=device)["params"])
        for (k, i), leaves in finals.items():
            ref = finals["serial", i]
            if not all(torch.equal(a, b) for a, b in zip(leaves, ref)):
                fail(f"sweep: the {k} run's parameters after stage {i} are "
                     "not the serial run's bits")

        # ---- the resume path's costs on a runner checkpoint of this run
        ck_dir = os.path.join(dirs["serial"], f"stage_01_b{budgets[1]}",
                              "ckpt")
        ck_step = checkpoint.latest_step(ck_dir)
        cfg = bcd.BCDConfig(b_target=budgets[1], drc=drc, rt=6,
                            adt=0.3, chunk_size=args.chunk_size,
                            moves=args.moves, proposal=args.proposal)
        deep_ms, restore_ms = [], []
        for _ in range(SWEEP_TIMED):
            sync(device)
            t0 = time.perf_counter()
            if not checkpoint.validate(ck_dir, ck_step, deep=True):
                fail(f"sweep: {ck_dir} step {ck_step} fails validation")
            deep_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            runner.restore_run_state(ck_dir, cfg, masks0,
                                     params_template=template, step=ck_step,
                                     verify=False, device=device)
            sync(device)
            restore_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    save = costs.summary("save", "runner")
    serial_stages = arts["serial"]["stages"]
    rows = (PATH_KERNELS["resnet18_sweep"] + ("masked_act_conv3x3",) +
            PATH_ROUTES["resnet18_sweep"])
    d_budgets = [s["budget"] for s in dflt["stages"]]
    return dict(
        model=model.cfg.name, relus=total, b_ref=b_ref, budgets=budgets,
        drc=drc, blocks_per_stage=steps, engine=args.engine,
        flags=flags + ["--sweep", schedule],
        cuts={"train_base_steps": TRAIN_STEPS,
              "snl_epochs_x_steps": [SNL_EPOCHS, SNL_STEPS],
              "snl_finetune_steps": FT_STEPS,
              "note": "the warm start has the training path's cuts; the "
                      "sweep runs the example's schedule (12 finetune "
                      "steps a block, rt 6, adt 0.3)"},
        seconds=time.perf_counter() - t_phase, warm_start_s=warm_s,
        wall_s=walls,
        stage_wall_s={k: [s["wall_s"] for s in a["stages"]]
                      for k, a in arts.items()},
        fingerprints=[s["mask_fingerprint"][:16] for s in serial_stages],
        test_acc=[s.get("test_acc") for s in serial_stages],
        resumed_from=resumed_from, kill_after_blocks=kill_after,
        identical={"stages": True, "final_params_bits": True,
                   "runs": ["serial", "overlap", "killed+resumed",
                            "two ranks (stage 0)"]},
        checkpoint=dict(
            save_runner=save,
            save_stage_init=costs.summary("save", "stage_init"),
            validate_deep_stage_init=costs.summary("validate", "stage_init"),
            restore_stage_init=costs.summary("restore", "stage_init"),
            resume_point=dict(dir_step=ck_step, validate_deep_ms=deep_ms,
                              restore_run_state_ms=restore_ms),
            bytes_per_runner_checkpoint=save["bytes"] if save else None,
            serial_stage_share=_save_share(costs, dirs["serial"], budgets,
                                           serial_stages),
            # a resume's deep validation + restore against a stage
            resume_share=[(min(deep_ms) + min(restore_ms)) / 1e3 /
                          s["wall_s"] for s in serial_stages]),
        launches={k: by_path["resnet18_sweep"][k] for k in rows},
        default_schedule=dict(
            sweep=default_schedule, budgets=d_budgets,
            drc=ex.sweep_drc(b_ref, d_budgets),
            blocks_per_stage=[s["steps"] for s in dflt["stages"]],
            wall_s=walls["default"],
            stage_wall_s=[s["wall_s"] for s in dflt["stages"]],
            save_runner=dcosts.summary("save", "runner"),
            serial_stage_share=_save_share(dcosts, dirs["default"],
                                           d_budgets, dflt["stages"]),
            launches={k: default_counts[k] for k in rows} | {
                k: v for k, v in default_counts.items() if v}))


# ---------------------------------------------------------------- LM paths
#
# StableLM-2-1.6B (d_model 2048, d_ff 5632, 32 heads of 64, vocab 100 352, 24
# layers) and RWKV-6 3B (d_model 2560, d_ff 8960, 40 heads of 64, vocab
# 65 536, 32 layers) at their published widths, random weights from the
# port's own init, run in float32 (a cut of dtype, not of width).  A network
# with random weights scores about 0 % next-token accuracy on Markov tokens,
# so every trial would tie; the eval tokens are therefore a short Markov
# prompt continued greedily by the full-mask model itself, and the positions
# after the prompt carry the model's own argmax as their label.


@dataclasses.dataclass(frozen=True)
class LMPath:
    arch: str
    tag: str            # prefix of the path's output lines
    seq: int            # tokens per eval sequence (inputs: seq - 1)
    pad: int            # greedy forwards pad their inputs to a multiple
    fused: bool         # the config has the fused gate→matmul route
    sited: tuple        # per-repeat sites of the ``<tag>_sited`` line
    cpu_repeats: int    # depth of the card-vs-CPU check (0: every layer)
    w_o_scale: float = 1.0   # factor on the init's block output projection
    bf16: bool = True   # one forward at the config's bfloat16 as well
    drc: int = LM_DRC   # nonlinearities removed per BCD step


LM_PATHS = (
    LMPath("stablelm_1p6b", "lm", 128, 1, True, ("s0.ffn@8", "s0.ffn@20"),
           0),
    # the RWKV time-mix scan needs S % min(32, S) == 0, as the reference
    # does: 128 inputs, and greedy forwards padded to multiples of 32; the
    # card-vs-CPU check runs the first 8 of 32 repeats (3.6 GB on the host).
    # At the init's own scales the random 32-block RWKV-6 is chaotic in
    # float32: its time-mix output is cubic in the block's input (r, k and v
    # are each linear in it) and the per-head norm keeps the relative error,
    # so rounding differences grow from block to block, and stacked and
    # un-stacked forwards of the same masks differ by O(1) in the logits.
    # So the time-mix w_o is drawn at 1/32 of the init's scale;
    # ``rwkv_forward`` measures both (``rounding_growth``).
    LMPath("rwkv6_3b", "rwkv", 129, 32, False, ("s0.rwkv@8", "s0.rwkv@24"),
           8, w_o_scale=1 / 32),
)
# The MoE and hybrid paths, each also served (``<tag>_serve`` line).
# DeepSeek-MoE-16B: a dense head block and 27 MoE blocks, 16.2 B parameters,
# 64.7 GB in float32 — no room for a bfloat16 copy beside them, so no
# bfloat16 forward; exact-length greedy forwards (pad 1: a MoE's capacity
# depends on the length); the card-vs-CPU check runs the head block and
# the first MoE repeat (3.5 GB on the host); 2.52 M nonlinearities, so a
# BCD step removes 4096 (0.16 %, StableLM's 256 of 135 k is 0.19 %).
# Zamba2-2.7B: 9 repeats of five Mamba2 blocks and the shared attention
# block; the Mamba2 scan needs S % min(64, S) == 0, as the reference does:
# 128 inputs, greedy forwards padded to multiples of 64; the CPU check runs
# the first 2 repeats.  Like RWKV-6, the random 54-layer model at the
# init's scales amplifies float32 rounding (1e-7 relative noise on the
# embedding moves the logits by ~7e-4, and the suffix and batched engines
# then rank some candidates apart); each Mamba2 ``w_out`` is drawn at 1/32
# of the init's scale, and ``hybrid_forward`` measures both
# (``rounding_growth``).
FAMILY_PATHS = (
    LMPath("deepseek_moe_16b", "moe", 128, 1, True, ("s0.moe@8", "s0.moe@20"),
           1, bf16=False, drc=4096),
    LMPath("zamba2_2p7b", "hybrid", 129, 64, False,
           ("s0.mamba@2", "s4.mamba@6"), 2, w_o_scale=1 / 32, drc=512),
)
FAMILY_SERVE_BATCH, FAMILY_SERVE_PROMPT, FAMILY_SERVE_GEN = 2, 16, 8


def make_lm(seed: int, spec, device="cuda", cfg=None, dtype="float32"):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(cfg or get_config(spec.arch), dtype=dtype)
    model = LM(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device)
    if spec.w_o_scale != 1.0:
        for w in output_projections(params):
            w.mul_(spec.w_o_scale)
    return model, params


def output_projections(params):
    """The stack's recurrent-block output projections that ``w_o_scale``
    scales: RWKV-6's time-mix ``w_o`` and Mamba2's ``w_out``."""
    out = []
    for layer in params["stack"].values():
        for block, leaf in (("tmix", "w_o"), ("mamba", "w_out")):
            if block in layer:
                out.append(layer[block][leaf])
    return out


def labelled_margins(logits, prompt: int):
    """Top-2 logit margin at every position whose label is a greedy token
    (positions prompt-1 .. S-1 of the inputs)."""
    top2 = logits[..., prompt - 1:, :].topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def last_logits(model, params, masks, toks, pad: int):
    """Logits at the last position of ``toks``, from a forward over the
    tokens padded with zeros to a multiple of ``pad``.  Exact: the models
    are causal — attention is masked, the RWKV token shift and scan look
    back only — so the logits at a position do not depend on the tokens
    after it."""
    n = toks.shape[1]
    width = -(-n // pad) * pad
    x = torch.cat([toks, toks.new_zeros((toks.shape[0], width - n))], dim=1)
    return model.forward(params, masks, x, ties=False)[:, n - 1]


def make_lm_batch(model, params, seed: int, spec, device="cuda"):
    """``2 * LM_BATCH`` Markov prompts continued greedily to ``spec.seq``
    tokens by the full-mask model (one full forward per new token, no
    cache); the ``LM_BATCH`` sequences whose smallest top-2 logit margin at
    the labelled positions is largest form the eval batch, so that rounding
    differences between evaluation paths stay far below the margins."""
    from repro_torch.core import linearize, masks as M
    from repro_torch.data import MarkovTokens
    n_seq, prompt, pool = LM_BATCH, LM_PROMPT, 2 * LM_BATCH
    full = M.as_device(linearize.init_masks(model.mask_sites()), device)
    start = MarkovTokens(model.cfg.vocab, seed=seed).batch(pool, prompt, 0)
    toks = torch.from_numpy(start["tokens"]).long().to(device)
    with torch.no_grad():
        while toks.shape[1] < spec.seq:
            nxt = last_logits(model, params, full, toks, spec.pad).argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        logits = model.forward(params, full, toks[:, :-1], ties=False)
        margin = labelled_margins(logits, prompt).amin(-1)
        keep = margin.argsort(descending=True)[:n_seq]
        tokens = toks[keep]
        hit = logits[keep].argmax(-1) == tokens[:, 1:]
    return {"tokens": tokens.to(torch.int32).cpu().numpy()}, dict(
        model=model.cfg.name, pool=pool, sequences=n_seq, tokens=spec.seq,
        prompt=prompt, pad_greedy_forwards_to=spec.pad,
        min_label_margin=float(margin[keep].min()),
        full_mask_accuracy=float(hit.float().mean() * 100.0),
        greedy_positions_reproduced=float(
            hit[:, prompt - 1:].float().mean()))


def first_repeats(model, params, tree, n: int):
    """The model cut to its head blocks and its first ``n`` stack repeats
    (0: as it is), with the parameter rows and mask rows of those repeats
    (views on the card; a shared block's one parameter set as it is)."""
    from repro_torch.models.lm import LM
    cfg = model.cfg
    if not n or n >= cfg.n_repeats:
        return model, params, tree
    if cfg.tail:
        raise ValueError("first_repeats: the config has tail blocks")
    cut = LM(dataclasses.replace(
        cfg, n_layers=len(cfg.head_blocks) + n * len(cfg.pattern)))

    def rows(t):
        return {k: rows(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    sub = dict(params, stack={
        str(pos): params["stack"][str(pos)] if blk.shared
        else rows(params["stack"][str(pos)])
        for pos, blk in enumerate(cfg.pattern)})
    reps = model.site_repeats()
    return cut, sub, {k: v[:n] if k in reps else v for k, v in tree.items()}


def run_lm_forward(model, params, batch, seed: int, spec, device="cuda"):
    """Stacked vs un-stacked and stacked from the cached embedding (kernel
    2, and kernel 4 where the config has the fused route), un-stacked
    unfused vs fused (kernel 3) where it has, card vs CPU on 1 x
    ``LM_CPU_TOKENS`` tokens, and one bfloat16 forward.  On a MoE model
    each comparison holds the logits to LM_LOGIT_TOL at every position
    before the first token the two forwards routed differently
    (:func:`held_diff`) and counts the rest."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    rng = np.random.default_rng(seed)
    sites = model.mask_sites()
    trees = [{k: (rng.random(s.shape) < 0.9).astype(np.float32)
              for k, s in sites.items()} for _ in range(2)]
    tokens = to_device(batch["tokens"], device)
    x = tokens[:, :-1]
    fused = spec.fused

    def routed(fn):
        rec = record_routes()
        with rec:
            out = fn()
        return out, rec.calls
    with torch.no_grad():
        dev = [M.as_device(t, device) for t in trees]
        plain = [routed(lambda d=d: model.forward(params, d, x, ties=False))
                 for d in dev]
        stacked = M.as_device(M.stack_trees(trees), device)
        st_plain = routed(lambda: model.forward(params, stacked, x,
                                                ties=False))
        pre = model.forward_pre(params, x)
        st_pre = routed(lambda: model.forward(params, stacked, None, pre=pre,
                                              fused=fused, ties=False))
        diffs, held = {}, {}
        pairs = {"stacked_vs_unstacked": [(st_plain, plain[i], i)
                                          for i in range(2)],
                 "stacked_fused_pre_vs_unstacked" if fused else
                 "stacked_pre_vs_unstacked": [(st_pre, plain[i], i)
                                              for i in range(2)]}
        outs = [p[0] for p in plain] + [st_plain[0], st_pre[0]]
        if fused:
            fz = [routed(lambda d=d: model.forward(params, d, x, fused=True,
                                                   ties=False)) for d in dev]
            pairs = {"fused_vs_unfused": [(fz[i], plain[i], None)
                                          for i in range(2)], **pairs}
            outs += [f[0] for f in fz]
        for name, items in pairs.items():
            diffs[name], held[name] = held_diff(items, 2)
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
        dropped = [sum(int((~keep).sum()) for _, _, keep in p[1])
                   for p in plain]
        margin = float(labelled_margins(plain[0][0], LM_PROMPT).min())
        shapes = [list(plain[0][0].shape), list(st_plain[0].shape)]
        ref_logits = plain[0][0]
        del outs, plain, st_plain, st_pre, pre, pairs
        if fused:
            del fz
        # the same network (or its first spec.cpu_repeats repeats) on the
        # CPU, through the plain versions
        small = x[:1, :LM_CPU_TOKENS]
        cut, cut_params, cut_tree = first_repeats(model, params, trees[0],
                                                  spec.cpu_repeats)
        cpu_params = to_device(cut_params, "cpu")
        want = routed(lambda: cut.forward(cpu_params,
                                          M.as_device(cut_tree, "cpu"),
                                          small.cpu(), ties=False))
        del cpu_params
        got = routed(lambda: cut.forward(
            cut_params, M.as_device(cut_tree, device), small, fused=fused,
            ties=False))
        finite = finite and bool(torch.isfinite(got[0]).all())
        got = (got[0].cpu(), [tuple(t.cpu() for t in c) for c in got[1]])
        diffs["card_vs_cpu"], held["card_vs_cpu"] = held_diff(
            [(got, want, None)], 1)
    seq = spec.seq - 1
    if shapes != [[LM_BATCH, seq, model.cfg.vocab],
                  [2, LM_BATCH, seq, model.cfg.vocab]]:
        fail(f"{spec.tag}_forward: logits shapes {shapes}")
    if not finite:
        fail(f"{spec.tag}_forward: non-finite logits")
    for k, v in diffs.items():
        if not v <= LM_LOGIT_TOL:
            fail(f"{spec.tag}_forward: {k} = {v} exceeds {LM_LOGIT_TOL} "
                 f"({held[k]})")
        if held[k]["positions_held"] < held[k]["positions"] / 2:
            fail(f"{spec.tag}_forward: {k}: routes differ before half the "
                 f"positions ({held[k]})")
    out = dict(model=model.cfg.name, dtype="float32", batch=LM_BATCH,
               tokens=seq, nonlinearities=model.relu_count(),
               mask_density=0.9, logit_tol=LM_LOGIT_TOL,
               max_abs_diff=diffs, cpu_check=f"1 x {LM_CPU_TOKENS} tokens, "
               f"{cut.cfg.n_layers} of {model.cfg.n_layers} layers",
               min_top2_margin_labelled=margin)
    if any(h["moe_layers"] for h in held.values()):
        out["routes"] = dict(held, dropped_pairs_unstacked=dropped)
    out["bfloat16"] = run_lm_bf16(model.cfg, trees[0], x, spec, ref_logits,
                                  device) if spec.bf16 else (
        "not run: the float32 parameters leave no room for a bfloat16 copy")
    if spec.w_o_scale != 1.0:
        out["w_o_scale"] = spec.w_o_scale
        out["rounding_growth"] = rounding_growth(model, params, trees, x,
                                                 spec, device)
    return out


class record_routes:
    """Within the block, the experts each MoE routing chose, the source
    token of each sorted (token, k) pair and whether it kept its slot
    (``models.moe._sorted_slots`` wrapped): chip_smoke.py compares the
    routes of two forwards and finds dropped pairs with it.  The port
    itself never records."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe._sorted_slots

        def wrapped(eidx, c, C):
            out = self.inner(eidx, c, C)
            self.calls.append((eidx, out[1], out[2]))
            return out
        moe._sorted_slots = wrapped
        return self

    def __exit__(self, *exc):
        self.moe._sorted_slots = self.inner


def held_diff(items, n: int):
    """Largest |a - b| over every (a, b) pair of ``items`` at the
    positions held, and the counts behind it.  Each item is ``((logits,
    routes), (logits, routes), i)``: a forward's logits and the MoE
    routings :class:`record_routes` kept, ``i`` the candidate of a stacked
    first forward (of ``n``) to compare, or None.  A position is held
    where both forwards routed every token up to and including it alike in
    every MoE layer: a model without MoE layers holds every position."""
    worst, worst_free, held_n, total, differ, compared, layers = \
        0.0, 0.0, 0, 0, 0, 0, 0
    for (la, ra), (lb, rb), i in items:
        if i is not None:
            la = la[i]
        free = torch.zeros(lb.shape[:-1], dtype=torch.bool)      # (B, S)
        layers = len(rb)
        for (ea, _, _), (eb, _, _) in zip(ra, rb):
            if i is not None:
                ea = ea.reshape((n,) + tuple(eb.shape))[i]
            ne = (ea != eb).cpu()
            differ += int(ne.sum())
            compared += ne.numel()
            free |= ne.any(-1).reshape(free.shape)
        free = torch.cummax(free.to(torch.int8), dim=-1).values.bool()
        d = (la - lb).abs().amax(-1).cpu()
        worst = max(worst, float(d[~free].max()) if (~free).any() else 0.0)
        if free.any():
            worst_free = max(worst_free, float(d[free].max()))
        held_n += int((~free).sum())
        total += free.numel()
    return worst, dict(moe_layers=layers, routes_compared=compared,
                       routes_differ=differ, positions=total,
                       positions_held=held_n,
                       max_abs_diff_not_held=worst_free)


def rounding_growth(model, params, trees, x, spec, device="cuda"):
    """Why the path scales its output projections (RWKV-6's time-mix
    ``w_o``, Mamba2's ``w_out``): the largest logit difference between a
    stacked and an un-stacked forward of the same masks, and under 1e-7
    relative noise on the embedding, at the path's scale and at the init's
    own (the projections restored afterwards)."""
    from repro_torch.core import masks as M
    w_os = output_projections(params)
    saved = [w.clone() for w in w_os]
    g = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    with torch.no_grad():
        one = M.as_device(trees[0], device)
        stacked = M.as_device(M.stack_trees(trees), device)
        pre = model.forward_pre(params, x)
        noisy = pre * (1 + 1e-7 * torch.randn(pre.shape, generator=g,
                                              device=device))
        for label, factor in (("path_scale", 1.0),
                              ("init_scale", 1.0 / spec.w_o_scale)):
            for w, w0 in zip(w_os, saved):
                w.copy_(w0 * factor)
            a = model.forward(params, one, None, pre=pre, ties=False)
            st = model.forward(params, stacked, None, pre=pre, ties=False)
            nz = model.forward(params, one, None, pre=noisy, ties=False)
            out[label] = {
                "stacked_vs_unstacked": float((st[0] - a).abs().max()),
                "embedding_noise_1e-7": float((nz - a).abs().max())}
            del a, st, nz
        for w, w0 in zip(w_os, saved):
            w.copy_(w0)
    return out


def run_lm_bf16(cfg, tree, x, spec, f32_logits, device="cuda"):
    """One forward at the config's own dtype (the same random draws,
    rounded): fused against unfused where the config has the fused route,
    otherwise against the float32 forward's logits."""
    from repro_torch.core import masks as M
    model, params = make_lm(SEED, spec, device, cfg=cfg, dtype="bfloat16")
    with torch.no_grad():
        d = M.as_device(tree, device)
        plain = model.forward(params, d, x, ties=False)
        other = model.forward(params, d, x, fused=True, ties=False) \
            if spec.fused else f32_logits
        agree = float((plain.argmax(-1) == other.argmax(-1)).float().mean())
        diff = float((plain.float() - other.float()).abs().max())
        ok = bool(torch.isfinite(plain).all() and torch.isfinite(other).all())
    del params, plain, other
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if not ok:
        fail(f"{spec.tag}_forward bfloat16: non-finite logits")
    return dict(compared="fused vs unfused" if spec.fused else
                "bfloat16 vs float32", top1_agreement=agree,
                max_abs_logit_diff=diff)


def run_lm_bcd(model, params, batch, steps: int, drc: int, spec,
               device="cuda"):
    """``bcd.run_bcd`` on the LM through the four engines: identical
    selections, and at least one step whose trials did not all tie."""
    from repro_torch.core import bcd, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    total = model.relu_count()
    rt = 16
    prints, runs, step_accs = {}, [], []
    for backend in ("sequential", "batched", "pipelined", "suffix"):
        holder = {"params": params}
        evaluator, eval_acc, _ = make_bcd_evaluator(
            backend, model, batch, holder, chunk_size=LM_CHUNK, rt=rt,
            prefetch=2, fused_kernels=spec.fused, device=device)
        if backend == "batched":
            # record every trial accuracy (rt per step, in order)
            inner = evaluator.evaluate_staged

            def recording(staged, inner=inner):
                accs = inner(staged)
                step_accs.extend(float(a) for a in accs)
                return accs
            evaluator.evaluate_staged = recording
        cfg = bcd.BCDConfig(b_target=total - drc * steps, drc=drc, rt=rt,
                            adt=-100.0, finetune_every_step=False, seed=0,
                            chunk_size=LM_CHUNK, moves=("remove",))
        before = counts()
        sync(device)
        t0 = time.perf_counter()
        res = bcd.run_bcd(masks0, cfg, eval_acc, evaluator=evaluator)
        sync(device)
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in counts().items()}
        if M.relu_cost(res.masks) != total - drc * steps:
            fail(f"{spec.tag}_bcd {backend}: budget "
                 f"{M.relu_cost(res.masks)}")
        accs = [h.acc_before for h in res.history]
        if not all(np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs):
            fail(f"{spec.tag}_bcd {backend}: accuracies {accs}")
        trials = sum(h.trials for h in res.history)
        prints[backend] = M.fingerprint(res.masks)
        run = dict(backend=backend, steps=len(res.history), trials=trials,
                   wall_s=wall,
                   candidates_per_s=(trials + len(res.history)) / wall,
                   fingerprint=prints[backend][:16],
                   best_drops=[h.best_drop for h in res.history],
                   acc_before=accs,
                   launches={k: v for k, v in launches.items() if v})
        trie = getattr(evaluator, "trie", None)
        if trie is not None:
            run["trie"] = dict(hits=trie.hits, extensions=trie.extensions,
                               misses=trie.misses)
        runs.append(run)
    if len(set(prints.values())) != 1:
        emit({f"{spec.tag}_bcd_failed": runs})
        fail(f"{spec.tag}_bcd: engines selected different blocks: {prints}")
    distinct = [len(set(step_accs[i:i + rt]))
                for i in range(0, len(step_accs), rt)]
    if not distinct or max(distinct) < 2:
        fail(f"{spec.tag}_bcd: every step's trials tied ({distinct} "
             "distinct accuracies per step): the parity would be vacuous")
    return dict(model=model.cfg.name, dtype="float32", batch=LM_BATCH,
                tokens=spec.seq - 1, drc=drc, rt=rt, chunk_size=LM_CHUNK,
                adt=-100.0, moves=["remove"], steps=steps,
                distinct_trial_accs_per_step=distinct, runs=runs)


def run_lm_sited(model, params, batch, drc: int, spec, device="cuda"):
    """Site-local candidates at mid-scan per-repeat sites through the
    batched engine and the suffix engine, unfused and (where the config has
    the fused route) fused: equal accuracies, prefix reuse in the trie,
    and the rates."""
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    fractions = model.site_prefix_fractions()
    rng = np.random.default_rng(0)
    n_cand, reps, out = 16, 2, []
    engines = [("batched", "batched", False),
               ("suffix_unfused", "suffix", False)]
    if spec.fused:
        engines.append(("suffix_fused", "suffix", True))
    for site in spec.sited:
        idx = M.sample_removal_indices_within(
            rng, masks0, drc, n_cand, [site],
            repeat_sites=model.site_repeats())
        chunks = [M.materialize_candidates(masks0, idx[i:i + LM_CHUNK])
                  for i in range(0, n_cand, LM_CHUNK)]
        accs, row = {}, dict(site=site, prefix_fraction=fractions[site],
                             candidates=n_cand, chunk_size=LM_CHUNK, drc=drc)
        for label, backend, fused in engines:
            ev, _, _ = make_bcd_evaluator(
                backend, model, batch, {"params": params},
                chunk_size=LM_CHUNK, rt=n_cand, prefetch=0,
                fused_kernels=fused, device=device)
            items = chunks
            if backend == "suffix":
                ev.begin_step(masks0)
                items = [E.SitedChunk(site, c) for c in chunks]
            before = counts()
            accs[label] = np.concatenate([ev.evaluate(it) for it in items])
            launches = {k: v - before[k] for k, v in counts().items()}
            sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                for it in items:
                    ev.evaluate(it)
            sync(device)
            wall = time.perf_counter() - t0
            row[label] = dict(candidates_per_s=reps * n_cand / wall,
                              launches_first_pass={
                                  k: v for k, v in launches.items() if v})
            if backend == "suffix":
                t = ev.trie
                row[label]["trie"] = dict(hits=t.hits,
                                          extensions=t.extensions,
                                          misses=t.misses)
                if t.misses + t.extensions == 0:
                    fail(f"{spec.tag}_sited {site} {label}: no prefix was "
                         f"computed (trie {row[label]['trie']})")
            if fused and device == "cuda" and \
                    launches["masked_act_matmul_2d_batched"] == 0:
                fail(f"{spec.tag}_sited {site}: the fused suffix did not "
                     "launch masked_act_matmul_2d_batched")
        for label, a in accs.items():
            if not np.array_equal(a, accs["batched"]):
                emit({f"{spec.tag}_sited_failed": sited_diagnosis(
                    model, params, batch, masks0, chunks, site, a,
                    accs["batched"], label == "suffix_fused", device)})
                fail(f"{spec.tag}_sited {site}: {label} accuracies {a} "
                     f"differ from batched {accs['batched']}")
        row["accs"] = [float(a) for a in accs["batched"]]
        row["suffix_vs_batched"] = {
            lab: row[lab]["candidates_per_s"] /
            row["batched"]["candidates_per_s"]
            for lab, _, _ in engines[1:]}
        out.append(row)
    return dict(model=model.cfg.name, dtype="float32", batch=LM_BATCH,
                tokens=spec.seq - 1, timed_passes=reps, rows=out)


def profile_forwards(model, params, batch, seed: int):
    """One un-stacked forward and one of LM_CHUNK stacked candidates
    (unfused, density-0.9 masks) under ``torch.profiler``: kernel launches
    a forward, device time by kernel family and the device's busy share of
    the wall-clock (:func:`profile_window`)."""
    from repro_torch.core import masks as M
    rng = np.random.default_rng(seed)
    sites = model.mask_sites()
    trees = [{k: (rng.random(s.shape) < 0.9).astype(np.float32)
              for k, s in sites.items()} for _ in range(LM_CHUNK)]
    x = torch.from_numpy(batch["tokens"][:, :-1]).cuda()
    one = M.as_device(trees[0], "cuda")
    stacked = M.as_device(M.stack_trees(trees), "cuda")
    with torch.no_grad():
        return {
            "unstacked": profile_window(
                lambda _: model.forward(params, one, x, ties=False), 2),
            f"stacked_{LM_CHUNK}": profile_window(
                lambda _: model.forward(params, stacked, x, ties=False), 2)}


def run_family_serve(model, params, spec, device="cuda"):
    """``launch.serve.generate`` of FAMILY_SERVE_BATCH Markov prompts of
    FAMILY_SERVE_PROMPT tokens by FAMILY_SERVE_GEN tokens at full width
    (density-0.9 masks), every served token held to the uncached forward's
    argmax where its top-2 margin exceeds SERVE_MARGIN, and the decode
    step's time.

    A MoE decode step has one slot an expert and never drops a pair, while
    the uncached forward of a longer sequence drops pairs at capacity (the
    reference's rule; a random model's greedy tokens repeat and crowd their
    experts), so the positions from a dropped generated pair on are
    another function of the tokens.  The MoE is therefore judged with
    ``capacity_factor = E / top_k`` (no pair of any length is ever
    dropped, the decode step unchanged), and served once more at its own
    capacity, where the positions after an uncached drop are counted."""
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    rng = np.random.default_rng(SEED + 3)
    tree = {k: (rng.random(s.shape) < 0.9).astype(np.float32)
            for k, s in model.mask_sites().items()}
    masks = M.as_device(tree, device)
    P, n_gen = FAMILY_SERVE_PROMPT, FAMILY_SERVE_GEN
    prompts = torch.from_numpy(MarkovTokens(model.cfg.vocab, seed=SEED + 3)
                               .batch(FAMILY_SERVE_BATCH, P, 0)["tokens"]
                               ).long().to(device)
    cfg = model.cfg
    moe = any(b.kind == "moe" for b in cfg.head_blocks + cfg.pattern)

    def served(m):
        gen = serve.generate(m, params, masks, prompts, n_gen, ties=False,
                             keep_logits=True)
        seq = torch.cat([prompts, gen["tokens"].long()], dim=1)
        fulls = []
        judged = torch.ones((n_gen, FAMILY_SERVE_BATCH), dtype=torch.bool)
        with torch.no_grad():
            for t in range(n_gen):
                rec = record_routes()
                with rec:
                    fulls.append(last_logits(m, params, masks,
                                             seq[:, :P + t], spec.pad))
                for _, st, keep in rec.calls:
                    late = (st >= P) & ~keep            # (B, S·k)
                    judged[t] &= ~late.any(-1).cpu()
        j = judged.to(device)
        worst, checked, matched, near = judge_served(
            torch.stack(gen["logits"])[j], torch.stack(fulls)[j],
            gen["tokens"].long().T[j])
        return gen, dict(max_abs_diff_cached_vs_uncached=worst,
                         tokens_checked=checked, tokens_matched=matched,
                         tokens_within_margin=near,
                         tokens_after_uncached_drop=int((~judged).sum()))
    judge_model = LM(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)) if moe else model
    gen, check = served(judge_model)
    if check["tokens_after_uncached_drop"]:
        fail(f"{spec.tag}_serve: the uncached forward dropped a pair at "
             f"capacity_factor E / top_k ({check})")
    off = check["tokens_checked"] - check["tokens_matched"]
    if off:
        fail(f"{spec.tag}_serve: {off} of {check['tokens_checked']} served "
             f"tokens are not the uncached argmax where its top-2 margin "
             f"exceeds {SERVE_MARGIN}")
    pbytes = param_bytes(params)
    dec = gen["decode_ms"]
    out = dict(model=cfg.name, dtype="float32", batch=FAMILY_SERVE_BATCH,
               prompt=P, gen=n_gen, prefill_ms=gen["prefill_ms"],
               decode_ms_mean=float(np.mean(dec)),
               decode_ms_min=float(np.min(dec)), decode_steps=len(dec),
               decode_bound_ms=pbytes / HBM_BYTES_PER_S * 1e3,
               decode_bound_by="bytes (every parameter read once a step)",
               margin=SERVE_MARGIN, check=check)
    if moe:
        out["check"]["capacity_factor"] = cfg.n_experts / cfg.top_k
        out["own_capacity"] = dict(capacity_factor=cfg.capacity_factor,
                                   **served(model)[1])
    return out


def sited_diagnosis(model, params, batch, masks0, chunks, site, got, want,
                    fused, device="cuda"):
    """Why a suffix evaluation disagreed with the batched one: for each
    chunk holding a disagreeing candidate, the largest logit difference
    between the suffix forward over the shared prefix and the full stacked
    forward, the labelled positions whose argmax differs and their top-2
    margins there, and the MoE routes that differ."""
    from repro_torch.core import masks as M
    tokens = torch.from_numpy(batch["tokens"]).to(device).long()
    x, labels = tokens[:, :-1], tokens[:, 1:]
    base = M.as_device(masks0, device)
    out = []
    bad = np.flatnonzero(np.asarray(got) != np.asarray(want))
    with torch.no_grad():
        for c in sorted({int(b) // LM_CHUNK for b in bad}):
            st = M.as_device(chunks[c], device)
            ra, rb = record_routes(), record_routes()
            with ra:
                full = model.forward(params, st, x, ties=False)
            cached = model.forward_prefix(params, base, x, site)
            sub = {k: st[k] for k in model.suffix_sites(site)}
            with rb:
                suf = model.forward_suffix(params, sub, cached, site,
                                           fused=fused, ties=False)
            flip = full.argmax(-1) != suf.argmax(-1)
            top2 = full.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1])[flip]
            out.append(dict(
                chunk=c, max_abs_logit_diff=float((full - suf).abs().max()),
                argmax_flips=int(flip.sum()),
                flips_at_labels=int((flip & ((full.argmax(-1) == labels) |
                                             (suf.argmax(-1) == labels)))
                                    .sum()),
                margins_at_flips=[float(m) for m in margin[:8]],
                moe_routes_differ=sum(
                    int((a[0].reshape((-1,) + tuple(b[0].shape)) != b[0])
                        .sum())
                    for a, b in zip(ra.calls[-len(rb.calls):], rb.calls))
                if rb.calls else None))
    return out


def run_lm_path(spec, by_path, device="cuda"):
    """One LM path: the eval tokens are built first (set-up), then the
    launch counts are set to 0 just before the path and read just after.
    A family path (``FAMILY_PATHS``) also profiles its forwards, serves,
    and reports the card's peak memory."""
    from repro_torch.kernels import build
    family = spec.arch in {p.arch for p in FAMILY_PATHS}
    cuda = torch.device(device).type == "cuda"
    memory = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        memory["allocated_before_init"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params = make_lm(SEED, spec, device)
    sync(device)
    memory.update(param_bytes=param_bytes(params),
                  init_s=time.perf_counter() - t0)
    if cuda:
        memory["after_init_max_allocated"] = torch.cuda.max_memory_allocated()
    batch, batch_info = make_lm_batch(model, params, SEED, spec, device)
    emit({f"{spec.tag}_batch": batch_info})
    build.reset_launch_counts()
    forward = run_lm_forward(model, params, batch, SEED, spec, device)
    if family and cuda:
        forward["profile"] = profile_forwards(model, params, batch, SEED)
    bcd_report = run_lm_bcd(model, params, batch, LM_STEPS, spec.drc, spec,
                            device)
    sited = run_lm_sited(model, params, batch, LM_SITED_DRC, spec, device)
    served = run_family_serve(model, params, spec, device) if family \
        else None
    by_path[spec.arch] = counts()
    if cuda:
        memory["max_allocated"] = torch.cuda.max_memory_allocated()
        memory["device_total"] = torch.cuda.get_device_properties(0) \
            .total_memory
    if family:
        forward["memory"] = memory
    emit({f"{spec.tag}_forward": forward})
    emit({f"{spec.tag}_bcd": bcd_report})
    emit({f"{spec.tag}_sited": sited})
    if served is not None:
        emit({f"{spec.tag}_serve": served})
    del model, params
    # the evaluators hold the parameters in reference cycles: collect them
    # before the next path allocates its own (DeepSeek's take 64.7 GB)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


# ------------------------------------------------------------ serving


def judge_served(kept, full, tokens):
    """(largest |kept - full|, tokens checked, tokens equal to the uncached
    argmax, tokens within the margin): ``tokens`` is checked where the
    uncached logits' top-2 margin exceeds ``SERVE_MARGIN``."""
    top2 = full.topk(2, dim=-1)
    sure = (top2.values[..., 0] - top2.values[..., 1]) > SERVE_MARGIN
    hit = sure & (tokens.to(top2.indices.device) == top2.indices[..., 0])
    return (float((kept - full).abs().max()), int(sure.sum()),
            int(hit.sum()), int((~sure).sum()))


def served_consistency(model, params, store, reqs, pad, device):
    """Every completed request of a ``keep_logits`` loop against the
    uncached forward of its prompt and the tokens generated before each
    position (padded with zeros to a multiple of ``pad``, exact as in
    :func:`last_logits`): the largest logit difference, and each served
    token against the uncached argmax (:func:`judge_served`)."""
    worst, checked, matched, near = 0.0, 0, 0, 0
    with torch.no_grad():
        for r in reqs:
            seq = np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int64)
            n = len(seq)
            seq = np.concatenate([seq, np.zeros(-(-n // pad) * pad - n,
                                                np.int64)])
            full = model.forward(params, store.select(r.mask_set),
                                 torch.from_numpy(seq)[None].to(device),
                                 ties=False)[0, len(r.prompt) - 1:n]
            kept = torch.stack(r.logits)
            if kept.shape != full.shape or \
                    not bool(torch.isfinite(kept).all()):
                fail(f"serve: request {r.rid} kept logits "
                     f"{tuple(kept.shape)} vs {tuple(full.shape)}, or not "
                     "finite")
            w, c, m, k = judge_served(kept, full, torch.tensor(r.tokens))
            worst, checked, matched, near = (max(worst, w), checked + c,
                                             matched + m, near + k)
    if matched != checked:
        fail(f"serve: {checked - matched} of {checked} served tokens are not "
             f"the uncached argmax where its top-2 margin exceeds "
             f"{SERVE_MARGIN}")
    if not worst <= LM_LOGIT_TOL:
        fail(f"serve: cached vs uncached logits differ by {worst} > "
             f"{LM_LOGIT_TOL}")
    return dict(max_abs_diff_cached_vs_uncached=worst, logit_tol=LM_LOGIT_TOL,
                margin=SERVE_MARGIN, tokens_checked=checked,
                tokens_matched=matched, tokens_within_margin=near)


def serve_prompts(seed: int, n: int, lo: int, hi: int, vocab: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def drive_loop(loop, prompts, classes):
    """Submit the prompts in turn over the classes and drain the loop;
    returns the requests."""
    reqs = [loop.submit(p, classes[i % len(classes)])
            for i, p in enumerate(prompts)]
    loop.shutdown(drain=True)
    return reqs


def cache_bytes_read(model, cache_lens) -> int:
    """KV bytes a decode tick needs: every layer reads the K and V rows
    of each slot's positions 0..cache_len."""
    cfg = model.cfg
    row = cfg.n_kv_heads * cfg.head_dim * 4 * 2
    return int(sum(int(c) + 1 for c in cache_lens) * row * cfg.n_layers)


def param_bytes(params) -> int:
    """Bytes of every parameter, the embedding once (read as the head)."""
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            total += t.numel() * t.element_size()
    walk(params)
    return total


def time_serve_ticks(model, params, store, loop, device):
    """After the drive: the B=1 prefill's time by prompt length (CUDA
    events), one decode tick of a full lane (all slots live at ragged
    positions; host clock around a synchronised tick, as a user waits),
    our kernels' launches a tick, its byte bound, and one profiler window
    of ticks."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve_loop import _zero_
    name = store.names[0]
    masks = store.select(name)
    small = loop._small
    prefill_ms = {}
    with torch.no_grad():
        for n in SERVE_PREFILL_LENS:
            toks = torch.randint(0, model.cfg.vocab, (1, n), device=device,
                                 generator=torch.Generator(device=device)
                                 .manual_seed(n))
            prefill_ms[str(n)] = time_ms(lambda: loop._prefill(
                params, masks, toks, _zero_(small), n - 1, ties=False),
                reps=3, warm=1)
        lane = next(iter(loop.lanes.values()))
        cl = np.array(SERVE_TICK_CACHE_LENS[:loop.slots], np.int64)
        tok = torch.zeros((loop.slots, 1), dtype=torch.int32, device=device)

        def tick(_=0):
            return loop._decode(params, masks, tok, lane.cache, cl,
                                ties=False)
        for _ in range(2):
            tick()
        sync(device)
        walls = []
        before = dict(build.launch_counts)
        for _ in range(SERVE_TIMED_TICKS):
            t0 = time.perf_counter()
            tick()
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        per_tick = {k: (build.launch_counts[k] - before[k]) /
                    SERVE_TIMED_TICKS for k in before
                    if build.launch_counts[k] != before[k]}
        prof = profile_window(tick, 5)
    pbytes = param_bytes(params)
    kv = cache_bytes_read(model, cl)
    ms = float(np.mean(walls))
    bound = (pbytes + kv) / HBM_BYTES_PER_S * 1e3
    return dict(
        prefill_ms_by_prompt_len=prefill_ms,
        decode_tick=dict(slots=loop.slots, cache_lens=cl.tolist(),
                         ms_mean=ms, ms_min=float(np.min(walls)),
                         ms_max=float(np.max(walls)), ticks=len(walls),
                         tokens_per_s_per_slot=1e3 / ms,
                         tokens_per_s_total=loop.slots * 1e3 / ms,
                         our_kernel_launches=per_tick,
                         param_bytes=pbytes, kv_bytes_read=kv,
                         bound_ms=bound, bound_by="bytes",
                         bound_share=bound / ms),
        profile=prof)


def chaos_drill(model, params, device):
    """Reduced StableLM under ``default_chaos_plan(5)``, a queue bound of 4,
    the ladder, a virtual clock and deadlines on both classes; returns the
    loop and its requests."""
    from repro_torch.launch import faults, serve_loop
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS, seed=SEED,
                                           device=device)
    classes = [serve_loop.SLOClass("premium", store.names[0], 4,
                                   deadline_ms=900.0, priority=1),
               serve_loop.SLOClass("economy", store.names[1], 4,
                                   deadline_ms=2500.0)]
    loop = serve_loop.ServeLoop(
        model, params, store, classes, slots=2, max_len=32, prompt_bucket=8,
        ladder=serve_loop.DegradationLadder.from_store(store), queue_cap=4,
        clock=faults.VirtualClock(), fault_plan=faults.default_chaos_plan(5),
        device=device)
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(16):
        reqs.append(loop.submit(rng.integers(0, model.cfg.vocab,
                                             int(rng.integers(2, 20))),
                                ("premium", "economy")[i % 2]))
        if i % 3 == 2:
            loop.step()
    loop.shutdown(drain=True)
    return loop, reqs


def run_chaos_drill(device="cuda"):
    """The drill on ``device`` and on the CPU from the same parameters
    (drawn on the CPU from the seed): equal decision fingerprints, and
    every request's state, tokens and bill equal; admit, degrade and shed
    must all occur."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_device
    from repro_torch.launch import serve_loop
    model, cpu_params = make_lm(SEED, LM_PATHS[0], "cpu",
                                cfg=get_config("stablelm_1p6b").reduced())
    card, card_reqs = chaos_drill(model, to_device(cpu_params, device),
                                  device)
    cpu, cpu_reqs = chaos_drill(model, cpu_params, "cpu")
    fp = [serve_loop.decisions_fingerprint(x.decision_log)
          for x in (card, cpu)]
    seen = sorted({d["decision"] for d in card.decision_log})
    out = dict(model="stablelm_1p6b reduced", device=device,
               decisions_sha256=fp[0], cpu_decisions_sha256=fp[1],
               decisions=seen,
               states=[r.state for r in card_reqs],
               shed_reasons=sorted({r.shed_reason for r in card_reqs} - {""}),
               retries=card.stats()["retries"],
               tokens_equal=[r.tokens for r in card_reqs] ==
               [r.tokens for r in cpu_reqs],
               bills_equal=[r.bill for r in card_reqs] ==
               [r.bill for r in cpu_reqs])
    if fp[0] != fp[1] or not out["tokens_equal"] or not out["bills_equal"]:
        fail(f"serve: the chaos drill differs between {device} and the "
             f"CPU: {out}")
    if seen != ["admit", "degrade", "shed"]:
        fail(f"serve: the chaos drill decided only {seen}")
    return out


def run_serve_stablelm(device="cuda"):
    """StableLM-2-1.6B at full width, float32: a ``ServeLoop`` of two
    synthetic budgets, 4 slots of 128 tokens, prompts bucketed to 16,
    ``SERVE_REQUESTS`` requests of 4-100 tokens and 16 new tokens each,
    alternating between the classes; counts set to 0 just before the
    drive, read just after.  Then the served tokens against the uncached
    forward, and the timings."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve_loop
    model, params = make_lm(SEED, LM_PATHS[0], device)
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS, seed=SEED,
                                           device=device)
    classes = [serve_loop.SLOClass(f"c{i}", n, SERVE_MAX_NEW)
               for i, n in enumerate(store.names)]
    loop = serve_loop.ServeLoop(model, params, store, classes,
                                slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                prompt_bucket=16, device=device,
                                keep_logits=True)
    prompts = serve_prompts(SEED, SERVE_REQUESTS, 4, 100, model.cfg.vocab)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = drive_loop(loop, prompts, [c.name for c in classes])
    sync(device)
    wall = time.perf_counter() - t0
    launches = counts()
    if [r.state for r in reqs] != ["served"] * len(reqs) or \
            any(len(r.tokens) != SERVE_MAX_NEW for r in reqs):
        fail(f"serve: stablelm states {[r.state for r in reqs]}")
    stats = loop.stats()
    out = dict(model=model.cfg.name, dtype="float32", slots=SERVE_SLOTS,
               max_len=SERVE_MAX_LEN, prompt_bucket=16,
               requests=len(reqs), max_new=SERVE_MAX_NEW,
               prompt_lens=[len(p) for p in prompts],
               budgets={n: store.info(n).relu_cost for n in store.names},
               drive_s=wall,
               generated_tokens=sum(len(r.tokens) for r in reqs),
               loop_prefill_ms_p50={c: stats["classes"][c]["prefill_ms_p50"]
                                    for c in loop.lanes},
               loop_decode_tok_s_per_slot={
                   c: stats["classes"][c]["decode_tok_s"]
                   for c in loop.lanes},
               check=served_consistency(model, params, store, reqs,
                                        LM_PATHS[0].pad, device))
    for r in reqs:
        r.logits = None
    if torch.device(device).type == "cuda":
        out.update(time_serve_ticks(model, params, store, loop, device))
        del model, params, store, loop, reqs
        torch.cuda.empty_cache()
    return out, launches


def run_serve_rwkv(device="cuda"):
    """RWKV-6 3B at full width, float32 (time-mix ``w_o`` at 1/32, as the
    RWKV path): ``launch.serve.generate`` of RWKV_SERVE_BATCH prompts of
    RWKV_SERVE_PROMPT tokens by RWKV_SERVE_GEN tokens, every step's logits
    against the uncached forward of the same tokens; then a ``ServeLoop``
    with exact-length prefill on a few requests.  Counts set to 0 just
    before the two drives, read just after."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve, serve_loop
    model, params = make_lm(SEED, LM_PATHS[1], device)
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS, seed=SEED,
                                           device=device)
    masks = store.select(store.names[1])
    rng = np.random.default_rng(SEED + 1)
    prompts = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, (RWKV_SERVE_BATCH, RWKV_SERVE_PROMPT))).to(device)
    classes = [serve_loop.SLOClass(f"c{i}", n, 4)
               for i, n in enumerate(store.names)]
    loop = serve_loop.ServeLoop(model, params, store, classes, slots=2,
                                max_len=RWKV_LOOP_MAX_LEN, prompt_bucket=None,
                                device=device, keep_logits=True)
    loop_prompts = [np.random.default_rng(SEED + 2 + i).integers(
        0, model.cfg.vocab, n) for i, n in enumerate(RWKV_LOOP_PROMPTS)]
    build.reset_launch_counts()
    gen = serve.generate(model, params, masks, prompts, RWKV_SERVE_GEN,
                         ties=False, keep_logits=True)
    reqs = drive_loop(loop, loop_prompts, [c.name for c in classes])
    sync(device)
    launches = counts()
    seq = torch.cat([prompts, gen["tokens"].long()], dim=1)
    with torch.no_grad():
        full = torch.stack([model.forward(
            params, masks, seq[:, :RWKV_SERVE_PROMPT + t], ties=False)[:, -1]
            for t in range(RWKV_SERVE_GEN)])
    worst, checked, matched, _ = judge_served(
        torch.stack(gen["logits"]), full, gen["tokens"].long().T)
    if matched != checked or not worst <= LM_LOGIT_TOL:
        fail(f"serve: rwkv generate vs uncached: {checked - matched} of "
             f"{checked} tokens off, largest logit difference {worst}")
    if [r.state for r in reqs] != ["served"] * len(reqs):
        fail(f"serve: rwkv loop states {[r.state for r in reqs]}")
    out = dict(model=model.cfg.name, dtype="float32",
               w_o_scale=LM_PATHS[1].w_o_scale,
               generate=dict(batch=RWKV_SERVE_BATCH, prompt=RWKV_SERVE_PROMPT,
                             gen=RWKV_SERVE_GEN, prefill_ms=gen["prefill_ms"],
                             decode_ms_mean=float(np.mean(gen["decode_ms"])),
                             decode_ms_min=float(np.min(gen["decode_ms"])),
                             max_abs_diff_cached_vs_uncached=worst,
                             tokens_checked=checked, tokens_matched=matched),
               loop=dict(prompt_bucket=None, prompt_lens=list(
                   RWKV_LOOP_PROMPTS), max_len=RWKV_LOOP_MAX_LEN,
                   check=served_consistency(model, params, store, reqs,
                                            LM_PATHS[1].pad, device)))
    del model, params, store, loop, reqs, gen
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out, launches


def run_serve_path(by_path, device="cuda"):
    """The serving slice: StableLM-2-1.6B's continuous-batching loop,
    RWKV-6 3B's batched prefill + decode and its exact-length loop (their
    launch counts summed into ``by_path["serve"]``), and the reduced chaos
    drill on the card and on the CPU."""
    lm, lm_counts = run_serve_stablelm(device)
    rwkv, rwkv_counts = run_serve_rwkv(device)
    by_path["serve"] = {k: lm_counts[k] + rwkv_counts[k] for k in lm_counts}
    return dict(stablelm=lm, rwkv=rwkv, chaos_drill=run_chaos_drill(device),
                launches={k: v for k, v in by_path["serve"].items() if v})


# ------------------------------------------------- training the families


FAMILY_EXAMPLE = os.path.join(HERE, "examples", "torch_family_bcd_sweep.py")
# the reference's CI schedule (.github/workflows/ci.yml family-smoke) with
# the example's batch of FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ tokens
FAMILY_FLAGS = ("--sweep", "0.6,0.45", "--ref-frac", "0.75",
                "--train-steps", "10", "--batch", str(FAMILY_TRAIN_BATCH),
                "--seq", str(FAMILY_TRAIN_SEQ))
FAMILY_GRAD_REPEATS = 2      # the card-vs-CPU gradient check: 2 of 32
FAMILY_GRAD_TOL = 1e-3       # each leaf's relative L2 error, card vs CPU
FAMILY_PROFILED_STEPS = 3
@dataclasses.dataclass(frozen=True)
class FamilySweep:
    spec: LMPath        # the LM path's config, tag and output scaling
    engines: tuple      # the engines swept, from one persisted warm start
    layers: int = 0     # n_layers cut (0: every layer)
    lr_scale: float = 1.0   # factor on the example's learning rates
    lr_why: str = ""    # the loss seen first at the example's own


FAMILY_SWEEPS = (
    FamilySweep(LM_PATHS[1], ("batched", "suffix")),
    # AdamW's state for all 16.2 B parameters (~259 GB with the gradients
    # and the parameters) fits no single card: the dense head block and 4
    # MoE repeats, ~10.7 GB
    FamilySweep(FAMILY_PATHS[0], ("batched", "suffix"), layers=5),
    # at the example's learning rates (tuned on the reduced configs),
    # SNL's SGD at 1e-2 turned the full-width model's loss to NaN in its
    # first epoch (10.88 after training; measured on one H100)
    FamilySweep(FAMILY_PATHS[1], ("suffix",), lr_scale=1 / 32,
                lr_why="at the example's own, the loss after SNL was NaN "
                       "(10.88 after training)"),
)


def load_family_example():
    """``examples/torch_family_bcd_sweep.py`` as a module: the family path
    runs through the functions a user's run calls."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_family_example",
                                                  FAMILY_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_grad_check(model, params, ex, device="cuda"):
    """One float32 train step's gradients of RWKV-6 3B at full width, cut
    to its embedding and first ``FAMILY_GRAD_REPEATS`` of 32 repeats, on
    the card (the gates through ``gate_bwd_kernel``, the scans through
    ``rwkv6_scan_bwd``) and on the CPU (the plain versions), from the same
    parameters, random hard masks and the example's first batch: each
    leaf's relative L2 error within ``FAMILY_GRAD_TOL``."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.training import optimizer as opt_lib, train
    rng = np.random.default_rng(SEED)
    tree = {k: (rng.random(s.shape) < 0.6).astype(np.float32)
            for k, s in model.mask_sites().items()}
    cut, sub, sub_tree = first_repeats(model, params, tree,
                                       FAMILY_GRAD_REPEATS)
    args = ex.parse_args(["--out-dir", "unused"] + list(FAMILY_FLAGS))
    batch = MarkovTokens(cut.cfg.vocab, seed=0).batch(args.batch, args.seq,
                                                      0)

    def loss_fn(p, m, b):
        return train.cross_entropy(cut.forward(p, m, b["tokens"]),
                                   b["labels"])
    before = counts()
    with train.deterministic():
        loss_c, g_card = train.loss_and_grads(
            loss_fn, sub, M.as_device(sub_tree, device),
            to_device(batch, device))
    sync(device)
    launched = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    sub_cpu = to_device(sub, "cpu")
    loss_h, g_cpu = train.loss_and_grads(loss_fn, sub_cpu,
                                         M.as_device(sub_tree, "cpu"),
                                         to_device(batch, "cpu"))
    names = opt_lib.tree_leaves(_leaf_names(sub))
    per_leaf = {}
    for name, gc, gh in zip(names, opt_lib.tree_leaves(g_card),
                            opt_lib.tree_leaves(g_cpu)):
        gc = gc.cpu()
        if not bool(torch.isfinite(gc).all()):
            fail(f"family_grad: the card's gradient of {name} is not finite")
        per_leaf[name] = float((gc - gh).norm() / max(float(gh.norm()),
                                                      1e-30))
    worst = max(per_leaf, key=per_leaf.get)
    if per_leaf[worst] > FAMILY_GRAD_TOL:
        fail(f"family_grad: {worst}'s gradient on the card is "
             f"{per_leaf[worst]} (relative L2) from the CPU's, above "
             f"{FAMILY_GRAD_TOL}")
    for k in ("masked_act_2d_bwd", "rwkv6_scan_bwd"):
        if torch.device(device).type == "cuda" and not launched.get(k):
            fail(f"family_grad: the card's step launched no {k}")
    del g_card, g_cpu, sub_cpu
    return dict(model=cut.cfg.name, layers=cut.cfg.n_layers,
                repeats=FAMILY_GRAD_REPEATS, batch=[args.batch, args.seq],
                loss_card=float(loss_c), loss_cpu=float(loss_h),
                worst_leaf=worst, worst_l2_rel=per_leaf[worst],
                tol=FAMILY_GRAD_TOL, launched=launched,
                l2_rel_by_leaf=per_leaf)


class scored_losses:
    """Within the block, the example's stage scoring also records the
    held-out loss of the parameters it scores (each stage's, after the
    stage's finetune, in ``losses``), and each finetune's result its own
    (``ft_losses``, the BCD steps' and the stages'): measurement only, the
    functions are put back on exit."""

    def __init__(self, ex, device):
        self.ex, self.device, self.losses, self.ft_losses = ex, device, [], []
        self.ft_allocated = []      # the card's allocated bytes after each

    def __enter__(self):
        from repro_torch.convert import to_device
        from repro_torch.core import masks as M
        self.orig = orig = self.ex.make_closures
        self.orig_ft = orig_ft = self.ex.finetune
        held = {}

        def finetune(params, masks, sloss, batches, **kw):
            out = orig_ft(params, masks, sloss, batches, **kw)
            if torch.device(self.device).type == "cuda":
                self.ft_allocated.append(torch.cuda.memory_allocated())
            with torch.no_grad():
                self.ft_losses.append(float(sloss(
                    out, M.as_device(masks, self.device), held["b"],
                    False)[0]))
            return out
        self.ex.finetune = finetune

        def make_closures(model, mt, args, device="cuda"):
            batches, sloss, test_acc = orig(model, mt, args, device)
            test_b = held["b"] = to_device(
                mt.batch(args.eval_batch, args.seq, 10**6), device)

            def scored(m, p):
                with torch.no_grad():
                    self.losses.append(float(sloss(
                        p, M.as_device(m, device), test_b, False)[0]))
                return test_acc(m, p)
            return batches, sloss, scored
        self.ex.make_closures = make_closures
        return self

    def __exit__(self, *exc):
        self.ex.make_closures = self.orig
        self.ex.finetune = self.orig_ft


def profile_family_steps(ex, model, params, masks0, args, device):
    """The warm start's train step (AdamW, leaf by leaf, as
    ``snl.finetune`` takes it): ``FAMILY_PROFILED_STEPS`` steps profiled
    (:func:`profile_window`) after one that warms up, then one step
    outside the profiler with its forward + backward and its optimizer
    timed apart (host issue time, and time until the card is done)."""
    from repro_torch.core import masks as M
    from repro_torch.core.snl import _grad_leaves
    from repro_torch.data import MarkovTokens
    from repro_torch.training import optimizer as opt_lib, train
    batches, sloss, _ = ex.make_closures(
        model, MarkovTokens(model.cfg.vocab, seed=0), args, device)
    m_dev = M.as_device(masks0, device)
    opt = opt_lib.adamw(lr=ex.TRAIN_LR)
    leaves = opt_lib.tree_leaves(params)
    state = {"o": opt.init(leaves)}

    def loss(p, b):
        return sloss(p, m_dev, b, False)[0]

    def one(i):
        grads = _grad_leaves(loss, params, leaves, batches(i))
        opt_lib.step_leaves(opt, grads, state["o"], leaves)
    out = profile_window(one, FAMILY_PROFILED_STEPS)
    # one more step outside the profiler, its parts apart: the host's time
    # to issue each part, then the card's to finish it
    parts = {}
    t0 = time.perf_counter()
    b = batches(FAMILY_PROFILED_STEPS + 1)
    tree = opt_lib.tree_unflatten(params, leaves)
    for name, fn in (
            ("forward_backward",
             lambda: train.loss_and_grads(loss, tree, b)),
            ("optimizer", lambda: opt_lib.step_leaves(
                opt, opt_lib.tree_leaves(parts.pop("grads")), state["o"],
                leaves))):
        t1 = time.perf_counter()
        res = fn()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if name == "forward_backward":
            parts["grads"] = res[1]
        parts[f"{name}_issue_ms"] = (t2 - t1) * 1e3
        parts[f"{name}_ms"] = (t3 - t1) * 1e3
    parts["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["unprofiled_step"] = parts
    del leaves, state, tree, b
    return out


class checkpoints_without_parameters:
    """Within the block, the sweep's checkpoints keep all but the
    parameters: each BCD runner's run state and each stage's final masks
    are written, without the parameters beside them; a warm start saved
    to a path in ``whole`` is written whole.  A full-width RWKV-6 3B's
    parameters are 12.4 GB a checkpoint, the example writes one after every
    accepted block and one a stage (~150 GB over the family path), and the
    machine allows 45 GiB of disk writes a run.  The functions are put back
    on exit."""

    def __init__(self, whole):
        self.whole = {os.path.abspath(p) for p in whole}

    def __enter__(self):
        from repro_torch.core import runner
        self.runner = runner
        self.orig = orig_save, orig_ck = (runner.save_stage_init,
                                          runner.BCDRunner._checkpoint)
        whole = self.whole

        def save_stage_init(path, init, **kw):
            if os.path.abspath(path) not in whole:
                init = dict(init, params=None)
            return orig_save(path, init, **kw)

        def _checkpoint(bcd_runner, state):
            io, bcd_runner._params_io = bcd_runner._params_io, None
            try:
                orig_ck(bcd_runner, state)
            finally:
                bcd_runner._params_io = io
        runner.save_stage_init = save_stage_init
        runner.BCDRunner._checkpoint = _checkpoint
        return self

    def __exit__(self, *exc):
        self.runner.save_stage_init, self.runner.BCDRunner._checkpoint = \
            self.orig


def finetune_repeats(ex, params, masks, sloss, batches, device="cuda"):
    """The example's stage finetune (AdamW, ``FT_STEPS`` steps at
    ``FT_LR``) twice from the same parameters, hard masks and batches: the
    two results must be the same bits, leaf by leaf.  The BCD engines
    agree, and a resumed sweep repeats an interrupted one, only if they
    are."""
    from repro_torch.core.snl import finetune
    from repro_torch.training import optimizer as opt_lib
    results, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        out = finetune(params, masks, sloss, batches, steps=ex.FT_STEPS,
                       lr=ex.FT_LR, use_adam=True, device=device)
        sync(device)
        secs.append(time.perf_counter() - t0)
        results.append([t.cpu() for t in opt_lib.tree_leaves(out)])
        del out
    names = opt_lib.tree_leaves(_leaf_names(params))
    differ = [n for n, a, b in zip(names, *results) if not torch.equal(a, b)]
    if differ:
        fail(f"finetune_repeats: two finetunes from the same parameters, "
             f"masks and batches differ in {len(differ)} of {len(names)} "
             f"leaves, first {differ[:5]}")
    return dict(steps=ex.FT_STEPS, leaves=len(names), equal_bits=True,
                seconds=secs)


class warm_start_probe:
    """Within the block, the example's ``train_base`` and
    ``snl_warm_start`` (the first run's warm start, which ``ex.run`` makes
    itself) are timed and read: the held-out loss after each, a profile of
    the train step, ``rounding_growth`` for a scaled model and the
    finetune's repeatability (:func:`finetune_repeats`), all on the trained
    parameters.  Measurement only: the functions are put back on exit."""

    def __init__(self, ex, model, spec, held_loss, held, device):
        self.ex, self.model, self.spec = ex, model, spec
        self.held_loss, self.held, self.device = held_loss, held, device
        self.warm, self.allocated = {}, {}
        self.warm["allocated"] = self.allocated

    def mark(self, name):
        if torch.device(self.device).type == "cuda":
            self.allocated[name] = torch.cuda.memory_allocated()

    def __enter__(self):
        from repro_torch.core.snl import finetune as snl_finetune
        ex, warm, dev = self.ex, self.warm, self.device
        self.orig = orig_train, orig_snl = ex.train_base, ex.snl_warm_start

        def train_base(args, params, masks0, sloss, batches, device="cuda"):
            self.mark("init")
            # the warm start's training is none of the sweep's finetunes
            # that scored_losses records
            scored, ex.finetune = ex.finetune, snl_finetune
            t0 = time.perf_counter()
            try:
                trained = orig_train(args, params, masks0, sloss, batches,
                                     device)
            finally:
                ex.finetune = scored
            sync(dev)
            warm["train_s"] = time.perf_counter() - t0
            self.mark("trained")
            warm["loss_trained"] = self.held_loss(trained, masks0)
            if not math.isfinite(warm["loss_trained"]):
                fail(f"{self.spec.tag}_family_sweep: the loss after "
                     f"training is {warm['loss_trained']} (before: "
                     f"{warm.get('loss_init')})")
            if torch.device(dev).type == "cuda":
                warm["train_step"] = profile_family_steps(
                    ex, self.model, trained, masks0, args, dev)
                self.mark("profiled")
            rng = np.random.default_rng(SEED)
            hard = {k: (rng.random(v.shape) < 0.6).astype(np.float32)
                    for k, v in masks0.items()}
            warm["finetune_repeats"] = finetune_repeats(
                ex, trained, hard, sloss, batches, dev)
            self.mark("finetune_repeats")
            if self.spec.w_o_scale != 1.0:
                warm["rounding_growth_trained"] = rounding_growth(
                    self.model, trained, [masks0, hard],
                    self.held["tokens"], self.spec, dev)
            self.mark("rounding_growth")
            return trained

        def snl_warm_start(params, masks0, sloss, batches, b_ref,
                           device="cuda"):
            t0 = time.perf_counter()
            init = orig_snl(params, masks0, sloss, batches, b_ref, device)
            sync(dev)
            warm["snl_s"] = time.perf_counter() - t0
            self.mark("snl")
            warm["loss_snl"] = self.held_loss(init["params"], init["masks"])
            if not math.isfinite(warm["loss_snl"]):
                fail(f"{self.spec.tag}_family_sweep: the loss after SNL is "
                     f"{warm['loss_snl']}")
            return init
        ex.train_base, ex.snl_warm_start = train_base, snl_warm_start
        return self

    def __exit__(self, *exc):
        self.ex.train_base, self.ex.snl_warm_start = self.orig


def run_family_sweep(fam, ex, root, device="cuda"):
    """One family's sweep at its published widths: the example's ``run``
    on each engine, the first from the initial parameters (the warm start,
    train then SNL to B_ref, made by ``run`` itself and read by
    :class:`warm_start_probe`), each later one from the warm start the
    first persisted.  Returns the ``<tag>_family_sweep`` line and the
    launch counts of the path (set to 0 just before the first run, read
    after the last)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.convert import to_device
    from repro_torch.core import linearize, masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.kernels import build
    spec = fam.spec
    cuda = torch.device(device).type == "cuda"
    cfg = get_config(spec.arch)
    if fam.layers:
        cfg = dataclasses.replace(cfg, n_layers=fam.layers)
    t0 = time.perf_counter()
    model, params = make_lm(SEED, spec, device, cfg=cfg)
    sync(device)
    line = dict(model=model.cfg.name, layers=model.cfg.n_layers,
                param_bytes=param_bytes(params),
                init_s=time.perf_counter() - t0, engines=list(fam.engines),
                flags=list(FAMILY_FLAGS))
    grad = family_grad_check(model, params, ex, device) \
        if spec.arch == "rwkv6_3b" else None
    dirs = {e: os.path.join(root, f"{spec.tag}_{e}") for e in fam.engines}
    argv = {e: ["--arch", spec.arch, "--engine", e, "--out-dir", dirs[e],
                "--bench-history", os.path.join(root, "BENCH_history.jsonl")]
            + list(FAMILY_FLAGS) for e in fam.engines}
    args = ex.parse_args(argv[fam.engines[0]])
    mt = MarkovTokens(model.cfg.vocab, seed=0)
    _, sloss, _ = ex.make_closures(model, mt, args, device)
    held = to_device(mt.batch(args.eval_batch, args.seq, 10**6), device)
    masks0 = linearize.init_masks(model.mask_sites())
    total = M.count(masks0)
    line["learning_rates"] = dict(train=ex.TRAIN_LR, snl=ex.SNL_CFG["lr"],
                                  finetune=ex.FT_LR)

    def held_loss(p, m):
        with torch.no_grad():
            return float(sloss(p, M.as_device(m, device), held, False)[0])

    loss_init = held_loss(params, masks0)
    # the initial parameters go to the host: the first run trains from
    # them there, each later one restores the persisted warm start into
    # their structure, and the card holds the live parameters alone
    params = to_device(params, "cpu")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    init_dir = os.path.join(dirs[fam.engines[0]], "init")
    probe = warm_start_probe(ex, model, spec, held_loss, held, device)
    probe.warm.update(loss_init=loss_init, b_ref=int(total * args.ref_frac),
                      total=total)
    line["warm_start"] = probe.warm
    build.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    peak = 0
    runs = {}
    for e in fam.engines:
        if e != fam.engines[0]:
            # the warm start moves on (a copy would need another 12.4 GB
            # of the disk's 80)
            os.makedirs(dirs[e])
            shutil.move(init_dir, os.path.join(dirs[e], "init"))
            init_dir = os.path.join(dirs[e], "init")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with scored_losses(ex, device) as sc, \
                checkpoint_costs(device) as ck, \
                checkpoints_without_parameters([init_dir]), probe:
            payload = ex.run(ex.parse_args(argv[e]), model, params,
                             device=device)
        sync(device)
        wall = time.perf_counter() - t0
        stages = [dict(budget=st["budget"], steps=st["steps"],
                       trials=st["trials_total"], wall_s=st["wall_s"],
                       test_acc=st.get("test_acc"),
                       fingerprint=st["mask_fingerprint"])
                  for st in payload["stages"]]
        if not payload["complete"] or len(stages) != len(args.sweep):
            fail(f"{spec.tag}_family_sweep ({e}): the sweep did not "
                 f"complete: {stages}")
        for st, loss in zip(stages, sc.losses):
            st["loss_after"] = loss
        mid = payload.get("midscan")
        runs[e] = dict(
            warm_start="made" if e == fam.engines[0] else "reused",
            wall_s=wall, stages=stages, finetune_losses=sc.ft_losses,
            allocated_after_finetunes=sc.ft_allocated,
            checkpoint_s=sum(c["ms"] for c in ck.calls) / 1e3,
            checkpoint_bytes=sum(c.get("bytes", 0) for c in ck.calls),
            midscan=None if mid is None else mid["per_site_depth"]
            ["midscan"])
        if e == fam.engines[0]:
            probe.warm["persist_s"] = sum(
                c["ms"] for c in ck.calls if c["op"] == "save" and
                c["dir"].startswith(init_dir)) / 1e3
        if cuda:
            runs[e]["max_allocated"] = torch.cuda.max_memory_allocated()
            peak = max(peak, runs[e]["max_allocated"])
        del payload
        if len(sc.losses) != len(stages) or \
                not all(math.isfinite(x) for x in sc.losses):
            line["runs"] = runs
            emit({f"{spec.tag}_family_sweep_failed": line})
            fail(f"{spec.tag}_family_sweep ({e}): losses after the stages "
                 f"{sc.losses} are not one finite value a stage")
        gc.collect()
        # the stages' checkpoints go; the warm start stays for the next run
        for name in os.listdir(dirs[e]):
            if name.startswith("stage_"):
                shutil.rmtree(os.path.join(dirs[e], name))
    # the engines agree on the masks of every stage and, their finetunes
    # being deterministic, on the parameters' losses after every step
    for key, what in (("fingerprint", "stage fingerprints"),
                      ("loss_after", "held-out losses after the stages")):
        got = {e: [st[key] for st in r["stages"]] for e, r in runs.items()}
        if len({tuple(v) for v in got.values()}) != 1:
            fail(f"{spec.tag}_family_sweep: the engines' {what} differ: "
                 f"{got}")
    ft = {e: r["finetune_losses"] for e, r in runs.items()}
    if len({tuple(v) for v in ft.values()}) != 1:
        fail(f"{spec.tag}_family_sweep: the engines' losses after their "
             f"finetunes differ: {ft}")
    launches = counts()
    line.update(runs=runs, engines_agree=len(fam.engines) > 1 or None,
                launches={k: v for k, v in launches.items() if v})
    if cuda:
        line["max_allocated"] = peak
        line["device_total"] = torch.cuda.get_device_properties(0) \
            .total_memory
        if line["max_allocated"] >= line["device_total"]:
            fail(f"{spec.tag}_family_sweep: peak allocated "
                 f"{line['max_allocated']} is not below the card's memory")
    line["reduced"] = family_cuts(fam, model)
    if grad is not None:
        line["grad_check"] = grad
    del model, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return line, launches


@contextlib.contextmanager
def scaled_learning_rates(ex, factor: float):
    """Within the block, the family example's learning rates (the warm
    start's training, SNL's, the finetunes') times ``factor``."""
    saved = ex.TRAIN_LR, ex.SNL_CFG, ex.FT_LR
    ex.TRAIN_LR, ex.FT_LR = saved[0] * factor, saved[2] * factor
    ex.SNL_CFG = dict(saved[1], lr=saved[1]["lr"] * factor)
    try:
        yield
    finally:
        ex.TRAIN_LR, ex.SNL_CFG, ex.FT_LR = saved


def family_cuts(fam, model) -> list:
    """What the family sweep cuts, against the published configuration and
    the example's defaults."""
    cuts = [f"schedule: {' '.join(FAMILY_FLAGS)} (the reference's CI; the "
            "example's default --train-steps is 30)",
            "random weights from seed 0 (no pretrained checkpoint), "
            "synthetic Markov tokens",
            "float32 throughout (the config's bfloat16 is not run)"]
    if fam.layers:
        from repro_torch.configs import get_config
        full = get_config(fam.spec.arch).n_layers
        cuts.append(f"{fam.layers} of {full} layers: the dense head block "
                    f"and {fam.layers - len(model.cfg.head_blocks)} MoE "
                    "repeats")
    if fam.spec.w_o_scale != 1.0:
        cuts.append(f"recurrent output projections drawn at "
                    f"{fam.spec.w_o_scale} of the init's scale")
    if fam.lr_scale != 1.0:
        cuts.append(f"the example's learning rates x {fam.lr_scale}: "
                    f"{fam.lr_why}")
    if len(fam.engines) == 1:
        cuts.append(f"one engine ({fam.engines[0]})")
    cuts.append("the sweep's checkpoints keep no parameters (the BCD "
                "runners' run states and the stages' final masks are "
                "written; the warm start alone is written whole, once): "
                "the example writes 12.4 GB of RWKV-6 3B parameters after "
                "every accepted block and a stage, and the script keeps "
                "its disk writes under 45 GiB")
    return cuts


def run_family_path(by_path, device="cuda", only=None):
    """The family path: the three families' sweeps (``FAMILY_SWEEPS``),
    their launch counts summed into ``by_path["family_sweep"]`` (``only``:
    one family's tag, to run it alone).  Run
    directories live under ``build/family_sweep`` of this checkout (tens
    of GB of checkpoints at full width), removed at the end."""
    import shutil
    ex = load_family_example()
    # what the earlier paths left behind goes before 12.4 GB of parameters
    # and their AdamW state arrive
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    root = os.path.join(HERE, "build", "family_sweep")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    emit({"family_disk": dict(
        root=root, free_bytes=disk.free, total_bytes=disk.total,
        allocated_at_start=torch.cuda.memory_allocated()
        if torch.device(device).type == "cuda" else None)})
    total = None
    lines = []
    try:
        for fam in FAMILY_SWEEPS:
            if only is not None and fam.spec.tag != only:
                continue
            with scaled_learning_rates(ex, fam.lr_scale):
                line, launches = run_family_sweep(fam, ex, root, device)
            emit({f"{fam.spec.tag}_family_sweep": line})
            lines.append(line)
            total = launches if total is None else \
                {k: total[k] + launches[k] for k in total}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path["family_sweep"] = total
    return lines


def check_launches(by_path, paths) -> None:
    """Fail unless each path launched every kernel and route it must."""
    for path in paths:
        names = PATH_KERNELS[path] + PATH_ROUTES.get(path, ())
        missing = [k for k in names if by_path[path][k] == 0]
        if missing:
            fail(f"the {path} path launched these kernels no time: "
                 f"{missing}")
        if by_path[path]["rwkv6_scan:tf32x3"] != by_path[path]["rwkv6_scan"]:
            fail(f"the {path} path ran {by_path[path]['rwkv6_scan:serial']} "
                 "scans on route S, not route C")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="build and compare the kernels, then stop "
                         "(prints no result line)")
    ap.add_argument("--only-train", action="store_true",
                    help="build and compare the kernels, run the training "
                         "half, then stop (prints no result line)")
    ap.add_argument("--only-sweep", action="store_true",
                    help="build the kernels and run the resumable-sweep "
                         "phase alone, without the kernel comparison "
                         "(prints no result line)")
    ap.add_argument("--only-rwkv", action="store_true",
                    help="build the kernels and run the RWKV-6 3B path "
                         "alone, without the kernel comparison (prints no "
                         "result line)")
    ap.add_argument("--only-moe", action="store_true",
                    help="build the kernels and run the DeepSeek-MoE-16B "
                         "path alone, without the kernel comparison (prints "
                         "no result line)")
    ap.add_argument("--only-hybrid", action="store_true",
                    help="build the kernels and run the Zamba2-2.7B path "
                         "alone, without the kernel comparison (prints no "
                         "result line)")
    ap.add_argument("--only-serve", action="store_true",
                    help="build the kernels and run the serving phase "
                         "alone, without the kernel comparison (prints no "
                         "result line)")
    ap.add_argument("--only-family", nargs="?", const="all", default=None,
                    metavar="TAG",
                    help="build the kernels and run the family path alone "
                         "(the card-vs-CPU gradient check and the three "
                         "families' sweeps), without the kernel comparison; "
                         "with a tag (rwkv, moe, hybrid), that family's "
                         "sweep alone (prints no result line)")
    ap.add_argument("--src", default=None,
                    help="with --only-rwkv, --only-moe or --only-hybrid: "
                         "import repro_torch from this directory (another "
                         "checkout's src/), to compare two trees with the "
                         "same script")
    args = ap.parse_args()
    alone = {"rwkv6_3b": args.only_rwkv,
             "deepseek_moe_16b": args.only_moe,
             "zamba2_2p7b": args.only_hybrid}
    if args.src:
        if not any(alone.values()):
            fail("--src is for --only-rwkv, --only-moe or --only-hybrid")
        sys.path.insert(0, os.path.abspath(args.src))

    # before anything touches the card: segments that grow in place, so
    # that the family path's AdamW over 12.4 GB of parameters (5 copies
    # live, leaves of up to 2.9 GB coming and going) does not fragment the
    # 79 GiB into pieces too small for the next leaf
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")

    # before any cuBLAS handle exists, the workspace that training's
    # deterministic() asks for: the sweep's child processes inherit it, so
    # they and this process run the same cuBLAS algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import repro_torch
    from repro_torch.kernels import build
    repro_torch.use_full_float32()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit({"env": {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "python": sys.version.split()[0],
                  "nvcc": nvcc.strip().splitlines()[-2:],
                  "nvidia_smi_name_power_limit": smi,
                  "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                           "matmul": torch.backends.cuda.matmul.allow_tf32}}})

    t0 = time.perf_counter()
    lib = build.load()
    seconds = time.perf_counter() - t0
    # the silu gate's branch-free reciprocal against 1 / y, every float of
    # [1, 2^126]
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    build.check(lib, lib.masked_act_rcp_check(
        bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "masked_act_rcp_check")
    if int(bad.item()) != 0:
        fail(f"rcp_rn_fast differs from 1 / y for {int(bad.item())} floats")
    emit({"build": {"seconds": seconds, "library": str(build.build()),
                    "ptxas": ptxas_summary(build.build_log()),
                    "rcp_rn_fast_mismatches_of_1056964609": 0}})

    for spec in LM_PATHS[1:] + FAMILY_PATHS:
        if alone[spec.arch]:
            import repro_torch.kernels as K
            by_path = {}
            emit({f"only_{spec.tag}": {
                "repro_torch": os.path.dirname(K.__file__)}})
            run_lm_path(spec, by_path)
            check_launches(by_path, (spec.arch,))
            return
    if args.only_sweep:
        by_path = {}
        emit({"sweep": run_sweep_path(by_path)})
        check_launches(by_path, ("resnet18_sweep",))
        return
    if args.only_serve:
        by_path = {}
        emit({"serve": run_serve_path(by_path)})
        check_launches(by_path, ("serve",))
        return
    if args.only_family:
        by_path = {}
        run_family_path(by_path, only=None if args.only_family == "all"
                        else args.only_family)
        if args.only_family == "all":
            check_launches(by_path, ("family_sweep",))
        emit({"family_launches": {k: v for k, v in
                                  by_path["family_sweep"].items() if v}})
        return
    cases = run_kernel_cases()
    emit({"kernel_cases": cases})
    emit({"scan_copies": time_scan_copies(next(
        c["ms"] for c in cases if c["name"] == "rwkv6_scan" and
        c["primary"]))})
    if args.only_kernels:
        return
    if args.only_train:
        for name, line in zip(("train", "snl", "pipeline"),
                              run_train_path({})):
            emit({name: line})
        return

    # ---- path 1, ResNet18: counts set to 0 just before, read just after
    model, params, batch = make_model_and_batch(SEED)
    build.reset_launch_counts()
    forward = run_forward(model, params, batch, SEED)
    bcd_report = run_bcd_phase(model, params, batch, BCD_STEPS)
    sited = run_sited_phase(model, params, batch)
    by_path = {"resnet18": counts()}
    emit({"forward": forward})
    emit({"bcd": bcd_report})
    emit({"sited": sited})
    del model, params, batch
    torch.cuda.empty_cache()

    # ---- path 1's training half, counted on its own
    train_lines = run_train_path(by_path)
    torch.cuda.empty_cache()

    # ---- path 1's resumable sweep, counted on its own
    sweep_line = run_sweep_path(by_path)
    torch.cuda.empty_cache()

    # ---- paths 2 to 5, StableLM-2-1.6B, RWKV-6 3B, DeepSeek-MoE-16B and
    # Zamba2-2.7B
    for spec in LM_PATHS + FAMILY_PATHS:
        run_lm_path(spec, by_path)

    # ---- serving StableLM-2-1.6B and RWKV-6 3B, counted on its own
    serve_line = run_serve_path(by_path)

    # ---- training the LM families: the sweep of each, counted on its own
    run_family_path(by_path)

    check_launches(by_path, PATH_KERNELS)
    launches = {k: sum(p[k] for p in by_path.values())
                for k in build.launch_counts}

    for name, line in zip(("train", "snl", "pipeline"), train_lines):
        emit({name: line})
    emit({"sweep": sweep_line})
    emit({"serve": serve_line})
    kernels = []
    for name in build.launch_counts:
        mine = [c for c in cases if c["name"] == name]
        prim = next(c for c in mine if c["primary"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine
                               if c["dtype"] == "float32"),
            # null for the float32-only scan
            "max_abs_err_bf16": max((c["max_abs_err"] for c in mine
                                     if c["dtype"] == "bfloat16"),
                                    default=None),
            "ms": prim["ms"], "queued_ms": prim.get("queued_ms"),
            "plain_ms": prim["plain_ms"],
            "bound_ms": prim["bound_ms"], "bound_by": prim["bound_by"],
            "library_ms": prim["library_ms"],
            "shape": prim["shape"], "dtype": prim["dtype"],
            "tolerance": {"atol": prim["atol"], "rtol": prim["rtol"]}})
        if name in PORT_ONLY:
            kernels[-1]["port_only"] = PORT_ONLY[name]
        if name == "rwkv6_scan_bwd":
            kernels[-1]["tolerance"]["form"] = prim["tol"]
        if name == "masked_act_2d_bwd":
            kernels[-1]["dpoly_max_abs_err"] = max(
                c.get("dpoly_max_abs_err", 0.0) for c in mine)
            kernels[-1]["dpoly_tolerance"] = next(
                c["dpoly_tol"] for c in mine if "dpoly_tol" in c)
        if name.startswith("masked_act_matmul"):
            kernels[-1]["by_route"] = matmul_routes(name, mine, by_path)
        if name.startswith("masked_act_conv3x3"):
            kernels[-1].update(conv_routes(name, mine, by_path))
        if name == "rwkv6_scan":
            kernels[-1].update(scan_routes(mine, by_path))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
