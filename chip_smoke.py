#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, and drives the port's five
model paths, BCD candidate evaluation through ``bcd.run_bcd`` with the
sequential, batched, pipelined and suffix engines.  Every engine runs one
gate route per run (``fused_kernels``): under the fused route
and under the unfused one the engines must select the same blocks and read
every sited trial equal to the bit; the trials the two routes read apart
are reported, not gated:

  1. masked-ReLU ResNet18 at full CIFAR width (``forward``, ``bcd``,
     ``sited`` lines);
  2. StableLM-2-1.6B at its published widths, float32, random weights, on
     eval tokens that the full-mask model continues greedily from a Markov
     prompt (``lm_batch``, ``lm_forward``, ``lm_bcd``, ``lm_sited`` lines),
     and BCD at its own bfloat16 (``lm_bf16_bcd``: the batched and the
     suffix engine, both fused on route A, must select the same blocks;
     route A's stacked kernel must be launched);
  3. RWKV-6 3B the same way, on 8 of its 32 repeats (``rwkv_batch``,
     ``rwkv_forward``, ``rwkv_bcd``, ``rwkv_sited`` lines), its time-mix
     scan on the ``rwkv6_scan`` kernel
     (route C, on the tensor cores), its channel-mix gate on the gate
     kernels; no fused route;
  4. DeepSeek-MoE-16B the same way, float32, 14 of its 28 layers on the
     card (``moe_batch``, ``moe_forward``, ``moe_bcd``, ``moe_sited``,
     ``moe_serve`` lines), sited at ``s0.moe@4`` and ``s0.moe@10``: a
     dense head block and MoE blocks of 64 routed experts (top-6) and a
     shared expert; the routed experts' gate on kernels 1/2, the dense
     head block and the shared experts fused (kernels 3/4, route B) under
     ``fused=``; ``moe_forward`` counts the (token, k) routes that differ
     between evaluation paths, profiles a forward and reports the card's
     peak memory;
  5. Zamba2-2.7B the same way (``hybrid_*`` lines), on 3 of its 9
     repeats of five Mamba2 blocks (gate on kernels 1/2, the scan in plain
     PyTorch, as
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
fingerprints, tokens and bills must be equal.  Then the same in the
configs' own bfloat16 (``serve`` line, ``bfloat16``): each model built at
its published widths from the same seed's draws rounded — StableLM-2-1.6B
through the same ``ServeLoop``, RWKV-6 3B (8 of 32 repeats),
DeepSeek-MoE-16B (all 28 layers) and Zamba2-2.7B (18 of 54), each at
its LM path's depth but DeepSeek, through ``generate`` — each served
sequence held to the uncached bfloat16 forward and the float32 forward of
the same parameters, upcast; a tie of bfloat16 logits; and
``python -m repro_torch.launch.serve --arch stablelm_1p6b`` as a user runs
it, in a child process.
Then training the LM families (``<tag>_family_sweep`` lines,
``--only-family`` alone): RWKV-6 3B's train-step gradients on the card
against the CPU's, then ``examples/torch_family_bcd_sweep.py``'s own
functions at the published widths — RWKV-6 3B on 2 of its 32 repeats,
DeepSeek-MoE-16B on 3 of its 28 layers, Zamba2-2.7B on 6 of its 54 —
train → SNL → a budget sweep on two engines, whose stages and losses must
agree; then the same in the configs' own bfloat16
(``<tag>_bf16_family_sweep``) at the same depths, each with its
card-vs-CPU gradient check in bfloat16.
Then training an LM (``lm_train`` line, ``--only-lm-train`` alone):
StableLM-2-1.6B at its published widths in its own bfloat16 through the
launcher's own ``launch.train.run`` (8 steps of 8 x 128 tokens, remat,
AdamW + cosine, one checkpoint of parameters and moments, read back and
compared with the final state to the bit); from its final state,
gradients and a step with remat on and off (equal to the bit), a step with
``loss_chunk`` against the whole sequence, the card's
``quantize_grads_int8`` against the CPU's and a 2-layer cut's gradients
against the CPU's, in float32 and in bfloat16; a profiled step; the
supervisor drill at reduced width in bfloat16 (a failure injected at step
13 gives the bits of an uninterrupted run, a rerun with more steps
resumes); and ``examples/torch_train_lm.py`` at its defaults (one
restart, BCD on the batched engine: kernel 2).

After path 1's resumable sweep, candidate-parallel BCD (``sharded_bcd``
line, ``--only-sharded`` alone): ResNet18 at full width, 4 ranks of one ``gloo`` process group
sharing the card, each a child process of this one under a timeout, run
``run_bcd`` on ``core.engine.ShardedEvaluator`` over a ``("cand",
"batch") = (2, 2)`` mesh (chunks of 8, the joint layout, and of 6, the
candidate-only one, whose ranks split the eval batch) and over a 1-D mesh
of 4; every rank must select the blocks of a one-process batched run,
by the reference's standard, and launch kernels 1, 2, 5 and 6; then
``make_evaluator("sharded")`` in this process at a world of 1, and
``training.pp.gpipe_forward`` on the card with stages through the gate,
against the stages applied in turn.  Then sharded serving and training
(``sharded_serve`` and ``sharded_train`` lines, ``--only-sharded-serve`` /
``--only-sharded-train`` alone), on one spawn of 4 ``gloo`` ranks sharing
the card, the models tensor-parallel over ``"model"`` and data-parallel
(ZeRO-3 in training) over ``"data"``: StableLM-2-1.6B at full width and
all 24 layers, float32, through ``ServeLoop(mesh=)`` on ``(1, 4)`` and
``(2, 2)``, and RWKV-6 3B at full width on 8 of 32 repeats on ``(1, 4)``,
each rank's decisions and tokens against the one-process loop's (run by
this process meanwhile), its served tokens against the sharded uncached
argmax, its logits within 1e-3 of the sharded and of the one-process
uncached forward, each decode tick timed with its collectives; then the
MoE and hybrid families split over ``"model"`` (``sharded_moe_serve``,
``sharded_hybrid_serve`` and ``sharded_family_train`` lines,
``--only-sharded-family`` alone): DeepSeek-MoE-16B at its published
widths, float32, 4 of 28 layers, on ``(1, 4)`` and ``(2, 2)``, and
Zamba2-2.7B, 6 of 54 layers, on ``(1, 4)``, a prefill of 4 × 64 tokens and
4 greedy decode steps against this process's one-process run (tokens
equal, logits within 1e-3 up to the first forward whose routes differ,
differing routes counted, the model ranks of a batch slice routing
alike), and a float32 SGD step of each on ``(2, 2)`` against one
process's under the float32 gates below; then
StableLM-2-1.6B in bfloat16, 2 of 24 layers: the first step's loss and
gradients on ``(2, 2)`` against one process's by the bfloat16 rule, a
float32 step against one process's within 1e-4, ``launch.train.run
--mesh 2,2`` under the supervisor with a failure against the
uninterrupted run to the bit, and its checkpoint restored onto ``(4, 1)``
and onto this process to the bit.  A rank that exits non-zero fails the
run; each phase fails on its own gates.

Every phase line carries its ``seconds``; a ``disk_writes`` line sums the
bytes of the checkpoints this process wrote (the machine allows 45 GiB of
disk writes a run).  Each path runs with the launch counts set to 0 just
before it and read just after; the script checks that each went through
its kernels and that the engines select identical blocks.

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
    sums of r terms; and a second launch gives the same bits.  bfloat16
    (x, g and dx; float32 arithmetic, dx rounded once, as the plain
    version): dx equal to the plain version's bits for relu and sqrelu,
    within one bfloat16 ulp of it for gelu and silu (tanhf / expf may
    differ from PyTorch's by a float32 ulp, which can cross a bfloat16
    rounding boundary); dpoly |err| <= 1e-5*sum|terms| (plus one bfloat16
    ulp where poly, and so dpoly, is bfloat16).
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
    S's.  Keeping the chunks' states for the backward changes neither y
    nor the state by a bit.
  * RWKV-6 scan backward, float32: each of dr, dk, dv, dw, du and ds0
    within 1e-5 of its largest entry + 1e-5*|ref| of the plain backward,
    and its error against the plain backward in float64 within 4x the
    float32 plain backward's, on route ``tf32x3`` from the states route C
    kept (as the path calls it) and alone, and on route ``serial``, forced
    beside it; finite under strong decay; two launches equal to the bit.
  * LM training (``lm_train``, bfloat16): every step's loss finite; the
    checkpoint read back equal to the state to the bit; remat on vs off,
    gradients, parameters, moments and metrics equal to the bit (the
    recomputation runs the same operations on the same inputs);
    ``loss_chunk`` vs the whole sequence, the loss within 2^-8 and
    ``grad_norm`` within 2^-6 relative (in float32 the reference's own
    test's 1e-5 and 1e-3; in bfloat16 the logits are bfloat16 products
    that cuBLAS may sum in another order at another row count);
    ``quantize_grads_int8``, card vs CPU, equal to the bit; card vs CPU
    gradients of a 2-layer cut, in float32 (the bfloat16 parameters
    upcast) each leaf's relative L2 error <= 1e-3, as the family path's,
    and in bfloat16 each leaf's relative L2 error against the CPU's
    float32 gradient within twice the CPU's bfloat16 gradient's plus 2^-5
    (the pattern of the CPU tests, tests/test_torch_train_bf16.py); the
    supervisor drill's final state equal to the bit to an uninterrupted
    run's.
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
  * Served in bfloat16 (the configs' own): the served sequence through the
    uncached bfloat16 forward (teacher forcing); each served token its
    argmax at all but 5 % of the positions, a position whose uncached
    top-2 margin is within 4 bfloat16 ulps of its top logit counting as
    agreeing (two bfloat16 evaluations whose products are summed in other
    orders swap such an argmax; an elementwise bound between two bfloat16
    forwards would measure where each rounds); the float32 forward of the
    same parameters, upcast, is the yardstick: the cached logits' largest
    error against it at most 2x the uncached bfloat16 forward's, plus 1e-3
    — the cache adds no error beyond what bfloat16 costs — and the cached
    argmax agrees with the float32 one at no fewer positions than the
    uncached argmax does, less 5 %.  The MoE at ``capacity_factor = E /
    top_k``, its two yardsticks taken with the routes the served run chose
    (the routes differing between the cached and the uncached path are
    counted).  ``torch.argmax`` takes the first index of a tie, as
    ``jnp.argmax``.
  * Family sweeps in bfloat16: the card-vs-CPU gradients by the
    ``lm_train`` bfloat16 rule above, on each family's first repeats; on
    DeepSeek the routers' and routed experts' leaves are not held where a
    route of the card's forward differs from the CPU's (counted).

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

# the H100 SXM's rates (dense), kept in one place: the port's roofline
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S,             # device memory
    PEAK_FLOPS as BF16_FLOP_PER_S,         # bfloat16 tensor cores
    PEAK_FLOPS_F32 as FP32_FLOP_PER_S,     # float32, outside the tensor cores
    PEAK_FLOPS_TF32 as TF32_FLOP_PER_S)    # TF32 tensor cores

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
    "rwkv6_scan_bwd": _CSRC + "rwkv6_scan_bwd_sm90.cu",
}
# the fused conv's routes (kernels.masked_act.conv_route)
CONV_SOURCE = {"tf32x3": _CSRC + "masked_act_conv_sm90.cu",
               "fma": _CSRC + "masked_act.cu"}
# the scan's routes (kernels.rwkv6_scan.scan_route)
SCAN_SOURCE = {"tf32x3": _CSRC + "rwkv6_scan_sm90.cu",
               "serial": _CSRC + "rwkv6_scan.cu"}
# the scan backward's routes (kernels.rwkv6_scan.scan_bwd_route)
SCAN_BWD_SOURCE = {"tf32x3": _CSRC + "rwkv6_scan_bwd_sm90.cu",
                   "serial": _CSRC + "rwkv6_scan_bwd.cu"}
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
    # every rank of the candidate-parallel phase (each checked on its own
    # too), the world of 1 and gpipe_forward's gates
    "sharded_bcd": ("masked_act_2d", "masked_act_2d_batched",
                    "masked_act_conv3x3", "masked_act_conv3x3_batched"),
    "serve": ("masked_act_2d", "rwkv6_scan"),
    "serve_bf16": ("masked_act_2d", "rwkv6_scan"),
    # DeepSeek's fused forwards add kernel 4 (every engine runs the fused
    # route; training is unfused)
    "family_sweep": ("masked_act_2d", "masked_act_2d_bwd",
                     "masked_act_2d_batched", "rwkv6_scan",
                     "rwkv6_scan_bwd", "masked_act_matmul_2d_batched"),
    # the same in bfloat16 (the gate's backward in bfloat16, the scans in
    # float32 inside the bfloat16 model); DeepSeek's fused suffix forwards
    # launch kernel 4 on route A where the suffix engine's cost model sends
    # a chunk down the sited path, reported by route, not required
    "family_sweep_bf16": ("masked_act_2d", "masked_act_2d_bwd",
                          "masked_act_2d_batched", "rwkv6_scan",
                          "rwkv6_scan_bwd"),
    # the LM train step (gate and its backward), the example's BCD pass on
    # the batched engine (kernel 2)
    "lm_train": ("masked_act_2d", "masked_act_2d_bwd",
                 "masked_act_2d_batched"),
    # sharded serving (every rank of every mesh; StableLM-2-1.6B's FFN gate
    # and RWKV-6's channel-mix gate at their F / model shards, RWKV-6's
    # scan on its H / model heads) and sharded training (the gate and its
    # backward on the F shard of the bfloat16 step)
    "sharded_serve": ("masked_act_2d", "rwkv6_scan"),
    "sharded_train": ("masked_act_2d", "masked_act_2d_bwd"),
    # the MoE and hybrid families over "model": DeepSeek-MoE-16B's routed
    # experts, shared expert and dense head block and Zamba2-2.7B's z
    # gate on each rank's columns, and their float32 train steps (the gate
    # and its backward)
    "sharded_moe_serve": ("masked_act_2d",),
    "sharded_hybrid_serve": ("masked_act_2d",),
    "sharded_family_train": ("masked_act_2d", "masked_act_2d_bwd"),
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
# forward and bfloat16 BCD on route A; RWKV-6's scans on route C (tensor
# cores), every one, and their backwards on route "tf32x3", every one;
# DeepSeek-MoE's float32 dense head block and shared experts on route B
PATH_ROUTES = {
    "resnet18": ("masked_act_conv3x3:tf32x3",
                 "masked_act_conv3x3_batched:tf32x3"),
    "stablelm_1p6b": ("masked_act_matmul_2d:fma", "masked_act_matmul_2d:wgmma",
                      "masked_act_matmul_2d_batched:fma",
                      "masked_act_matmul_2d_batched:wgmma"),
    "rwkv6_3b": ("rwkv6_scan:tf32x3",),
    "deepseek_moe_16b": ("masked_act_matmul_2d:fma",
                         "masked_act_matmul_2d_batched:fma"),
    "resnet18_sweep": ("masked_act_conv3x3_batched:tf32x3",),
    "serve": ("rwkv6_scan:tf32x3",),
    "serve_bf16": ("rwkv6_scan:tf32x3",),
    "family_sweep": ("rwkv6_scan:tf32x3", "rwkv6_scan_bwd:tf32x3",
                     "masked_act_matmul_2d_batched:fma"),
    "family_sweep_bf16": ("rwkv6_scan:tf32x3", "rwkv6_scan_bwd:tf32x3"),
    "sharded_serve": ("rwkv6_scan:tf32x3",),
}
# (rows, K, N_out) of the LM paths' fused products: every bfloat16 case at
# one of these must take route A (StableLM-2-1.6B's eval batch; DeepSeek's
# shared expert and dense head block at the family sweep's 4 x 32 tokens)
LM_MATMUL_SHAPES = {(1016, 5632, 2048), (128, 2816, 2048),
                    (128, 10944, 2048)}
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
    # bfloat16: equal bits (relu, sqrelu) or one bfloat16 ulp (gelu, silu),
    # checked in gate_bwd_case; one ulp is at most 2^-7 of the value
    ("gate_bwd", torch.bfloat16): (0.0, 2.0 ** -7),
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
LM_SITED_REPS = 1           # timed passes of a sited row, after its first
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
# serving in the configs' own bfloat16 (each model built at its published
# config from the path's seed's draws, rounded): StableLM-2-1.6B's loop as
# above; (batch, prompt, new tokens) of ``generate`` for RWKV-6 3B,
# DeepSeek-MoE-16B and Zamba2-2.7B.  Gates (judge_bf16, route_gate):
# every served token is the argmax of the logits it was served from; the
# cached logits' largest error against the float32 forward of the same
# parameters, upcast, is at most SERVE_BF16_RATIO times the uncached
# bfloat16 forward's plus SERVE_BF16_ABS (the cache adds no error beyond
# what bfloat16 costs); the served token is the uncached bfloat16
# forward's argmax (teacher forcing) at SERVE_BF16_TOKENS of all positions
# at least, a position where it is not counting as agreeing only where
# the two logits' uncached gap is within what the logit gate allows the
# two paths to differ by there: (1 + SERVE_BF16_RATIO) times the uncached
# forward's measured error against float32 at the two tokens, plus
# SERVE_BF16_ABS; on a MoE, no route of the first MoE layer differs
# between the cached and the uncached path, and every served expert that
# the yardstick's own router would not have chosen trails its k-th choice
# by at most twice what the logit gate allows: 2 (1 + SERVE_BF16_RATIO)
# times the layer's measured router-logit error of the bfloat16 forward
# against the float32 one
SERVE_BF16_GENERATE = ((RWKV_SERVE_BATCH, RWKV_SERVE_PROMPT, RWKV_SERVE_GEN),
                       (2, 16, 8), (2, 16, 8))
# bfloat16 serving's depth where it is not the LM path's: DeepSeek-MoE-16B
# serves all 28 layers.  Its LM path runs 14, and that model (other draws:
# every stacked leaf is drawn with its repeat axis) routes 2 (token, k)
# pairs of its first MoE layer otherwise cached and uncached in bfloat16
# (positions 0 and 2; one NVIDIA H100 80GB HBM3), which ``route_gate``
# refuses.  StableLM-2-1.6B serves 12 of its 24 layers in bfloat16 (all 24
# before, 20.7 s of the phase on one H100; the float32 ``serve`` line and
# ``sharded_serve`` keep all 24): the script's time
SERVE_BF16_LAYERS = {"deepseek_moe_16b": 0, "stablelm_1p6b": 12}
SERVE_BF16_TOKENS = 0.95
SERVE_BF16_RATIO, SERVE_BF16_ABS = 2.0, 1e-3
# the serve launcher as a user runs it on the card (no --reduced, no
# --device): the batch, prompt and generation flags alone
LAUNCHER_FLAGS = ("--batch", "4", "--prompt-len", "16", "--gen", "8")
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
                    "rwkv6_scan_tf32x3_kernel", "rwkv6_scan_kernel",
                    "rwkv6_scan_bwd_tf32x3_kernel", "rwkv6_scan_bwd_kernel",
                    "rwkv6_du_reduce_kernel")


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


def bf16_ulp(t):
    """One bfloat16 ulp at each entry of ``t``: 2^(e - 8) for |t| in
    [2^(e-1), 2^e), and the smallest subnormal's at 0."""
    t = t.float()
    _, e = torch.frexp(t)
    ulp = torch.ldexp(torch.ones_like(t), (e - 8).clamp_min(-133))
    return torch.where(t == 0, torch.full_like(t, 2.0 ** -133), ulp)


def gate_bwd_case(kind, rows, cols, poly, primary, seed, timed=False,
                  dtype=torch.float32, need_dpoly=None,
                  poly_dtype=torch.float32):
    """The gate's backward kernel against ``ref.masked_act_bwd_ref``: x with
    exact zeros (relu′(0) = 1/2), a binary mask, and with ``poly`` the
    poly2 replacement (of ``poly_dtype``) and, with ``need_dpoly`` (poly by
    default), its gradient, whose row sum must also come out the same, bit
    for bit, from a second launch.  ``dtype``: x, g and dx; in bfloat16,
    dx must equal the plain version's to the bit for relu and sqrelu and
    lie within one bfloat16 ulp of it for gelu and silu, and dpoly within
    1e-5 of the sum of its terms' magnitudes (plus a bfloat16 ulp of it
    when poly is bfloat16)."""
    from repro_torch.kernels import masked_act as K, ref
    name = "masked_act_2d_bwd"
    need_dpoly = poly if need_dpoly is None else need_dpoly
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device="cuda").to(dtype)
    x.view(-1)[::7] = 0.0
    mask = (torch.rand((cols,), generator=g, device="cuda") < 0.6).float()
    grad = torch.randn((rows, cols), generator=g, device="cuda").to(dtype)
    p = (torch.randn((3, cols), generator=g, device="cuda") * 0.3).to(
        poly_dtype) if poly else None

    def kernel():
        return K.masked_act_2d_bwd(x, mask, grad, p, kind=kind,
                                   need_dpoly=need_dpoly)

    def plain():
        return ref.masked_act_bwd_ref(x, mask, grad, kind, p, need_dpoly)

    (dx, dpoly), (want_dx, want_dp) = kernel(), plain()
    torch.cuda.synchronize()
    extra = dict(kind=kind, shape=[rows, cols], poly=poly,
                 need_dpoly=need_dpoly, shared_x=False,
                 zeros_in_x=int((x == 0).sum()))
    if dtype == torch.bfloat16:
        diff = (dx.float() - want_dx.float()).abs()
        ulps = diff / bf16_ulp(want_dx)
        extra["dx_max_ulps"] = float(ulps.max())
        extra["dx_tol"] = ("equal bits" if kind in ("relu", "sqrelu")
                           else "1 bfloat16 ulp")
        if kind in ("relu", "sqrelu") and not torch.equal(dx, want_dx):
            fail(f"{name} {extra}: dx differs from the plain version's "
                 f"bits at {int((diff > 0).sum())} entries")
        if bool((ulps > 1).any()):
            fail(f"{name} {extra}: dx is more than one bfloat16 ulp from "
                 "the plain version's")
        del diff, ulps
    if need_dpoly:
        xf, gf = x.float(), grad.float()
        g1m = gf * (1.0 - mask)
        terms = torch.stack([(g1m * xf * xf).abs().sum(0),
                             (g1m * xf).abs().sum(0), g1m.abs().sum(0)])
        if dtype == torch.float32:
            bound = 1e-7 + 2 * (rows - 1) * 2.0 ** -24 * terms
            extra["dpoly_tol"] = "1e-7 + 2*(rows-1)*2^-24*sum|terms|"
        else:
            bound = 1e-5 * terms
            extra["dpoly_tol"] = "1e-5*sum|terms|"
            if poly_dtype == torch.bfloat16:
                bound = bound + bf16_ulp(want_dp)
                extra["dpoly_tol"] += " + 1 bfloat16 ulp"
        err = (dpoly.float() - want_dp.float()).abs()
        extra["dpoly_max_abs_err"] = float(err.max())
        extra["dpoly_dtype"] = str(dpoly.dtype).replace("torch.", "")
        if dpoly.dtype != p.dtype or not torch.isfinite(dpoly).all() or \
                bool((err > bound).any()):
            fail(f"{name} {extra}: dpoly misses its tolerance")
        again = kernel()[1]
        torch.cuda.synchronize()
        if not torch.equal(again, dpoly):
            fail(f"{name} {extra}: two launches gave different dpoly bits")
        del again, err, terms, bound
    n_el = rows * cols
    esize = x.element_size()
    byts = nbytes(x, mask, grad, p) + esize * n_el + \
        (3 * cols * p.element_size() if need_dpoly else 0)
    flops = n_el * (6 + (9 if poly else 0))
    return finish_case(name, "gate_bwd", dtype, dx, want_dx, kernel,
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

    def keeping():
        return RS.rwkv6_scan(r, k, v, w, u, state, chunk=chunk,
                             keep_states=True)
    # under autograd route C also writes the chunks' states: the same y and
    # state to the bit
    kept = keeping()
    if not torch.equal(flat(kept[:2]), out):
        fail(f"rwkv6_scan {[bh, T, K, V]}: keeping the chunks' states "
             "changed y or the state")
    del kept
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
    if primary or timed:
        extra["keep_states_ms"] = time_ms(keeping)
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
    """The scan's backward (``rwkv6_scan_bwd``) on the route the rule picks
    (``"tf32x3"``) — from the chunks' states that route C of the forward
    keeps, as the path calls it, and alone, where the wrapper runs route C
    first to get them — and on route ``"serial"``, forced beside it, each
    against the plain version ``ref.rwkv6_scan_bwd_ref`` on the same inputs,
    gradient by gradient (``SCAN_BWD_ATOL``, ``SCAN_BWD_RTOL``), and against
    the plain backward in float64: each route's error within
    ``SCAN_ERR_RATIO`` times the float32 plain version's (the tensor-core
    rule).  Each route launched twice must give the same bits (du is summed
    over each head's rows in a fixed order), and be finite.  ``heads``,
    ``shared_state`` and ``strong`` as :func:`scan_case` (the plain backward
    never divides by a decay, so it stays finite under strong decay); the
    path's calls have a stride-0 zero state that needs no gradient and no
    gradient of the final state (``with_ds_end=False``: ds0 is not asked
    for).  Timed cases time both routes whole and queued, and the plain
    version; route ``"tf32x3"``'s bound counts its operations at the TF32
    rate, three passes each, route ``"serial"``'s at the float32 rate."""
    from repro_torch.kernels import build, ref, rwkv6_scan as RS
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
    rule = RS.scan_bwd_route(torch.float32, bh, T, K, V)
    # as the path calls it: from the chunks' states that route C of the
    # forward kept (ops.RWKV6ScanFn)
    states = RS.rwkv6_scan(r, k, v, w, u, state, chunk=1,
                           keep_states=True)[2]

    def kernel():
        return RS.rwkv6_scan_bwd(r, k, v, w, u, state, dy, ds_end,
                                 need_ds0=with_ds_end, states=states)

    def alone():
        return RS.rwkv6_scan_bwd(r, k, v, w, u, state, dy, ds_end,
                                 need_ds0=with_ds_end)

    def serial():
        with forced_route(RS, "scan_bwd_route", "serial"):
            return alone()

    def plain():
        return ref.rwkv6_scan_bwd_ref(r, k, v, w, u, state, dy, ds_end)

    extra = dict(scan_bwd_route=rule, shape=[bh, T, K, V],
                 decay="exp(-exp(U(-1, 3)))" if strong else "U(0.7, 0.999)",
                 u="(H, K) table" if heads > 1 else
                 "stride-0 row" if heads == 1 else "(BH, K)",
                 state="shared zeros" if shared_state else "random",
                 ds_end=with_ds_end,
                 tol=f"{SCAN_BWD_ATOL}*max|plain| + {SCAN_BWD_RTOL}*|plain|; "
                     f"error vs float64 <= {SCAN_ERR_RATIO}x the plain "
                     "version's")
    want = plain()
    f64 = ref.rwkv6_scan_bwd_ref(*(t.double() for t in (r, k, v, w, u,
                                                       state, dy)),
                                 None if ds_end is None else ds_end.double())
    by_route = {}
    variants = ((rule, rule, kernel), (rule + "_alone", rule, alone),
                ("serial", "serial", serial))
    for label, route, fn in variants:
        before = dict(build.route_counts)
        got = fn()
        took = [n.split(":")[1] for n, c in build.route_counts.items()
                if c != before[n] and n.startswith(name + ":")]
        again = fn()
        torch.cuda.synchronize()
        if took != [route]:
            fail(f"{name} {extra}: took routes {took}, asked for {route}")
        for n_, a, b in zip(names, got, again):
            if a is not None and not torch.equal(a, b):
                fail(f"{name} {extra}: two launches of route {route} gave "
                     f"different {n_} bits")
        del again
        max_err, errs = 0.0, {}
        for n_, a, b, c in zip(names, got, want, f64):
            if a is None:
                continue
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail(f"{name} {extra}: route {route}'s {n_} "
                     f"{tuple(a.shape)} is not finite or not the plain "
                     f"version's {tuple(b.shape)}")
            scale = float(b.abs().max())
            err = (a - b).abs()
            if bool((err > SCAN_BWD_ATOL * scale + SCAN_BWD_RTOL * b.abs())
                    .any()):
                fail(f"{name} {extra}: route {route}'s {n_} misses its "
                     f"tolerance by {float(err.max())} (scale {scale})")
            k_err = float((a.double() - c).abs().max())
            p_err = float((b.double() - c).abs().max())
            if not k_err <= SCAN_ERR_RATIO * p_err:
                fail(f"{name} {extra}: route {route}'s {n_} error against "
                     f"float64 {k_err} is above {SCAN_ERR_RATIO}x the plain "
                     f"version's {p_err}")
            errs[n_] = dict(max_abs_err=float(err.max()), scale=scale,
                            kernel_err_vs_f64=k_err, plain_err_vs_f64=p_err)
            max_err = max(max_err, float(err.max()))
        by_route[label] = dict(max_abs_err=max_err, errors=errs)
        del got
    del f64, want
    torch.cuda.empty_cache()
    case = dict(name=name, dtype="float32",
                max_abs_err=by_route[rule]["max_abs_err"],
                errors=by_route[rule]["errors"],
                alone_max_abs_err=by_route[rule + "_alone"]["max_abs_err"],
                serial_max_abs_err=by_route["serial"]["max_abs_err"],
                serial_errors=by_route["serial"]["errors"],
                atol=SCAN_BWD_ATOL, rtol=SCAN_BWD_RTOL, primary=primary,
                states_bytes=nbytes(states), **extra)
    if primary or timed:
        # read r, k, v, w, u, the state, dy (and ds_end) once, write dr, dk,
        # dv, dw, du (and ds0) once; per token and row: the state step
        # (2KV), dS's step, dr, dk, dv, dw (2KV each)
        byts = nbytes(r, k, v, w, u, state, dy, ds_end) + 4 * (
            3 * bh * T * K + bh * T * V + u.shape[0] * K +
            (bh * K * V if with_ds_end else 0))
        flops = bh * T * 12.0 * K * V
        t_bytes = byts / HBM_BYTES_PER_S * 1e3
        bounds = {"tf32x3": 3 * flops / TF32_FLOP_PER_S * 1e3,
                  "serial": flops / FP32_FLOP_PER_S * 1e3}
        for label, route, fn in variants:
            by_route[label].update(
                ms=time_ms(fn), queued_ms=queued_ms(fn),
                bound_ms=max(t_bytes, bounds[route]),
                bound_by="bytes" if t_bytes >= bounds[route]
                else "operations")
        case.update(ms=by_route[rule]["ms"],
                    queued_ms=by_route[rule]["queued_ms"],
                    alone_ms=by_route[rule + "_alone"]["ms"],
                    alone_queued_ms=by_route[rule + "_alone"]["queued_ms"],
                    serial_ms=by_route["serial"]["ms"],
                    serial_queued_ms=by_route["serial"]["queued_ms"],
                    plain_ms=time_ms(plain, reps=3, warm=1),
                    library_ms=None, bound_ms=by_route[rule]["bound_ms"],
                    bound_by=by_route[rule]["bound_by"],
                    serial_bound_ms=by_route["serial"]["bound_ms"],
                    serial_bound_by=by_route["serial"]["bound_by"],
                    bytes=byts, flops=flops)
    del states
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
        "keep_states_ms", "plain_ms", "bound_ms", "kernel_err_vs_f64",
        "serial_err_vs_f64", "plain_err_vs_f64", "plain_finite")}
        for c in mine if "serial_err_vs_f64" in c]
    return {"by_route": by_route, "by_shape": by_shape}


def scan_bwd_routes(mine, by_path) -> dict:
    """The scan backward's two routes side by side: each one's source,
    launches on the main paths, largest error against the plain version,
    and, at every timed shape, both routes' times whole and queued, their
    bounds and the plain version's time."""
    by_route = {route: {
        "source": SCAN_BWD_SOURCE[route],
        "launches": sum(p[f"rwkv6_scan_bwd:{route}"]
                        for p in by_path.values())}
        for route in ("tf32x3", "serial")}
    by_route["tf32x3"]["max_abs_err"] = max(c["max_abs_err"] for c in mine)
    by_route["serial"]["max_abs_err"] = max(c["serial_max_abs_err"]
                                            for c in mine)
    by_shape = [{key: c.get(key) for key in (
        "shape", "decay", "scan_bwd_route", "ms", "queued_ms", "alone_ms",
        "alone_queued_ms", "bound_ms", "bound_by", "serial_ms",
        "serial_queued_ms", "serial_bound_ms", "serial_bound_by", "plain_ms",
        "states_bytes")}
        for c in mine if "ms" in c]
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


def sharded_family_shapes():
    """The gate's (rows, columns) on one rank of the sharded MoE and hybrid
    lines: ``(serving, training)``, each a list of ``(where, rows,
    cols)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    B, P = SHARDED_FAMILY_BATCH, SHARDED_FAMILY_PROMPT
    ds = get_config(FAMILY_PATHS[0].arch)
    mc = lm._moe_cfg(ds)
    di = get_config(FAMILY_PATHS[1].arch).d_inner
    serve = []
    for shape in SHARDED_FAMILY_MESHES["moe"]:
        d, m = shape
        b = B // d
        for step, (rows, cap) in (("prefill", (b * P, moe._capacity(mc, P))),
                                  ("decode", (b, 1))):
            tag = f"deepseek {d}x{m} {step}"
            serve += [(f"{tag} routed", b * cap,
                       mc.n_experts * mc.d_ff_expert // m),
                      (f"{tag} shared", rows, mc.d_ff_shared // m),
                      (f"{tag} dense head", rows, ds.d_ff // m)]
    for d, m in SHARDED_FAMILY_MESHES["hybrid"]:
        serve += [(f"zamba2 {d}x{m} prefill", B // d * P, di // m),
                  (f"zamba2 {d}x{m} decode", B // d, di // m)]
    d, m = SHARDED_FAMILY_TRAIN_MESH
    S = SHARDED_FAMILY_TRAIN_SEQ
    rows = B // d * S
    trn = [(f"deepseek {d}x{m} train routed", B // d * moe._capacity(mc, S),
            mc.n_experts * mc.d_ff_expert // m),
           (f"deepseek {d}x{m} train shared", rows, mc.d_ff_shared // m),
           (f"deepseek {d}x{m} train dense head", rows, ds.d_ff // m),
           (f"zamba2 {d}x{m} train", rows, di // m)]
    return serve, trn


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
    # ... and in the configs' own bfloat16, at the decode step of each
    # model the serve phase runs in bfloat16: StableLM-2-1.6B's FFN over
    # the loop's slots, RWKV-6 3B's channel mix over the generate batch,
    # DeepSeek-MoE-16B's dense head block, shared expert and routed
    # experts (rows B·C of E·F columns, C slots an expert at one token
    # and the judged capacity factor E / top_k) and Zamba2-2.7B's Mamba2
    # gate, over a batch of FAMILY_SERVE_BATCH
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe
    moe_cfg = lm._moe_cfg(get_config(FAMILY_PATHS[0].arch))
    decode_moe_rows = FAMILY_SERVE_BATCH * moe._capacity(
        dataclasses.replace(moe_cfg, capacity_factor=moe_cfg.n_experts /
                            moe_cfg.top_k), 1)
    for i, (kind, rows, cols) in enumerate((
            ("silu", SERVE_SLOTS, 5632),
            ("sqrelu", RWKV_SERVE_BATCH, 8960),
            ("silu", FAMILY_SERVE_BATCH, 10944),
            ("silu", FAMILY_SERVE_BATCH, 2816),
            ("silu", decode_moe_rows, 64 * 1408),
            ("silu", FAMILY_SERVE_BATCH, 5120))):
        cases.append(gate_case(g2, bf16, kind, n=1, rows=rows, cols=cols,
                               poly=False, shared_x=False, primary=False,
                               seed=300 + i, timed=True))

    # the sharded phases' gates at their shard shapes (d_ff / model
    # columns): StableLM-2-1.6B's silu at a decode tick of every slot and a
    # B=1 prefill of the longest bucket on (1, 4), and a tick of a data
    # rank's 2 slots on (2, 2); RWKV-6 3B's sqrelu at a tick and at the
    # longest exact-length prefill on (1, 4); the bfloat16 train step's
    # silu on (2, 2) (a data rank's 4 x 128 tokens)
    for i, (dt, kind, rows, cols) in enumerate((
            (f32, "silu", SERVE_SLOTS, 5632 // 4),
            (f32, "silu", SERVE_PREFILL_LENS[-1], 5632 // 4),
            (f32, "silu", SERVE_SLOTS // 2, 5632 // 2),
            (f32, "sqrelu", SERVE_SLOTS, 8960 // 4),
            (f32, "sqrelu", max(RWKV_LOOP_PROMPTS), 8960 // 4),
            (bf16, "silu", 4 * 128, 5632 // 2))):
        cases.append(gate_case(g2, dt, kind, n=1, rows=rows, cols=cols,
                               poly=False, shared_x=False, primary=False,
                               seed=340 + i, timed=True))
    # ... and the sharded MoE and hybrid lines' gates on each rank's
    # columns (``sharded_family_shapes``): DeepSeek-MoE-16B's routed
    # experts (rows B·C of E·F / model columns), shared expert and dense
    # head block, Zamba2-2.7B's z gate (d_inner / model), at the prefill
    # and at a decode tick
    for i, (where, rows, cols) in enumerate(sharded_family_shapes()[0]):
        case = gate_case(g2, f32, "silu", n=1, rows=rows, cols=cols,
                         poly=False, shared_x=False, primary=False,
                         seed=360 + i, timed=True)
        case["sharded_family"] = where
        cases.append(case)

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
    # bfloat16 (the LMs' own dtype): the LM train step's FFN site of
    # StableLM-2-1.6B, silu on (8 x 128, 5632), timed; every kind with and
    # without poly, with and without dpoly, at ragged shapes (203 columns
    # take the scalar loads, 96 the 8-byte ones); one case with a bfloat16
    # poly (its dpoly in bfloat16)
    cases.append(gate_bwd_case("silu", 8 * 128, 5632, False, primary=False,
                               seed=240, timed=True, dtype=bf16))
    cases.append(gate_bwd_case("silu", 8 * 128, 5632, True, primary=False,
                               seed=241, timed=True, dtype=bf16))
    for i, kind in enumerate(kinds):
        for j, (poly, dpoly) in enumerate(((False, False), (True, False),
                                           (True, True))):
            cases.append(gate_bwd_case(kind, 37, 203, poly, primary=False,
                                       seed=250 + 3 * i + j, dtype=bf16,
                                       need_dpoly=dpoly))
            cases.append(gate_bwd_case(kind, 9, 96, poly, primary=False,
                                       seed=270 + 3 * i + j, dtype=bf16,
                                       need_dpoly=dpoly))
    cases.append(gate_bwd_case("gelu", 37, 96, True, primary=False, seed=290,
                               dtype=bf16, poly_dtype=bf16))
    # ... and at the bfloat16 family sweeps' training sites, rows of the
    # example's batch (FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ), timed:
    # RWKV-6 3B's channel-mix sqrelu, Zamba2-2.7B's Mamba2 gate,
    # DeepSeek-MoE-16B's dense head block and shared expert, and its
    # routed experts (rows B·C of E·F columns, C slots an expert at the
    # config's capacity factor)
    fam_rows = FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ
    train_moe_rows = FAMILY_TRAIN_BATCH * moe._capacity(
        moe_cfg, FAMILY_TRAIN_SEQ)
    for i, (kind, rows, cols) in enumerate((
            ("sqrelu", fam_rows, 8960), ("silu", fam_rows, 5120),
            ("silu", fam_rows, 10944), ("silu", fam_rows, 2816),
            ("silu", train_moe_rows, 64 * 1408))):
        cases.append(gate_bwd_case(kind, rows, cols, False, primary=False,
                                   seed=320 + i, timed=True, dtype=bf16))

    # ... and the sharded train step's F shard: StableLM-2-1.6B's silu on
    # (2, 2), a data rank's 4 x 128 tokens of 5632 / 2 columns
    cases.append(gate_bwd_case("silu", 4 * 128, 5632 // 2, False,
                               primary=False, seed=330, timed=True,
                               dtype=bf16))
    # ... and the sharded MoE and hybrid float32 steps' gates on (2, 2)
    for i, (where, rows, cols) in enumerate(sharded_family_shapes()[1]):
        case = gate_bwd_case("silu", rows, cols, False, primary=False,
                             seed=380 + i, timed=True)
        case["sharded_family"] = where
        cases.append(case)

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
    # ... and in bfloat16 on route A at the family sweep's shapes: rows of
    # the example's batch (FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ), the
    # shared expert's and the dense head block's K
    for i, k_moe in enumerate((2816, 10944)):
        cases.append(matmul_case(m2, bf16, "silu", 1, fam_rows, k_moe, nout,
                                 True, False, primary=False,
                                 seed=310 + 2 * i, timed=True))
        cases.append(matmul_case(m2b, bf16, "silu", LM_CHUNK, fam_rows,
                                 k_moe, nout, True, False, primary=False,
                                 seed=311 + 2 * i, timed=True))
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
    # sharded serving on (1, 4): a rank's 40 / 4 heads of a B=1 prefill,
    # from the cache's state, at the longest exact-length prompt and at one
    # of 20 tokens (one chunk of 20)
    for i, T in enumerate((max(RWKV_LOOP_PROMPTS), 20)):
        cases.append(scan_case(H3 // 4, T, 64, 64, min(32, T), H3 // 4,
                               False, primary=False, seed=400 + i,
                               timed=True))
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
    # every engine on the fused route; the stage_drop set's batched and
    # suffix engines on the unfused route as well (the other route's
    # selections must agree among themselves)
    engines = ("sequential", "batched", "pipelined", "suffix")
    for adt, moves in ((0.3, ("remove",)), (-100.0, ("remove",)),
                       (-100.0, ("remove", "stage_drop"))):
        prints = {}
        plan = [(b, True) for b in engines]
        if "stage_drop" in moves:
            plan += [("batched", False), ("suffix", False)]
        for backend, fused in plan:
            holder = {"params": params}
            evaluator, eval_acc, _ = make_bcd_evaluator(
                backend, model, batch, holder, chunk_size=chunk, rt=rt,
                prefetch=2, fused_kernels=fused, device="cuda")
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
            route = "fused" if fused else "unfused"
            prints[(route, backend)] = M.fingerprint(res.masks)
            run = dict(backend=backend, route=route, adt=adt,
                       moves=list(moves), steps=len(res.history),
                       trials=trials, wall_s=wall,
                       # candidate forwards the engine was asked for, plus
                       # one base-accuracy forward per step, per second
                       candidates_per_s=(trials + len(res.history)) / wall,
                       fingerprint=prints[(route, backend)][:16],
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
                        (launches["masked_act_conv3x3_batched"] > 0
                         or not fused)):
                    fail(f"bcd suffix {moves}: no sited chunk was evaluated "
                         f"(trie {run['trie']}, launches {launches})")
            runs.append(run)
        for route in ("fused", "unfused"):
            mine = {k: v for k, v in prints.items() if k[0] == route}
            if len(set(mine.values())) > 1:
                fail(f"bcd adt={adt} moves={moves}: engines selected "
                     f"different blocks on the {route} route: {mine}")
    return dict(model="resnet18", batch=128, drc=drc, rt=rt,
                chunk_size=chunk, steps=steps, runs=runs)


def run_sited_phase(model, params, batch):
    """Site-local candidates at two depths through the batched engine and
    the suffix engine, each on the unfused and on the fused gate route:
    under each route equal accuracies, and the rates the prefix reuse and
    the fused kernels are there for; between the routes, the trials read
    apart (reported)."""
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
        for label, backend, fused in route_engines(True):
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
        for route in ("unfused", "fused"):
            got, want = accs[f"suffix_{route}"], accs[f"batched_{route}"]
            if not np.array_equal(got, want):
                fail(f"sited {site}: suffix_{route} accuracies {got} differ "
                     f"from batched_{route} {want}")
        row["accs"] = {lab: [float(a) for a in v] for lab, v in accs.items()}
        row["routes_apart"] = routes_apart(accs)
        out.append(row)
    return dict(model="resnet18", batch=128, timed_passes=reps, rows=out)


# ------------------------------------------------------ candidate-parallel

SHARDED_WORLD = 4
SHARDED_RANK_TIMEOUT_S = 420    # each rank, from its start
# (label, mesh shape, chunk size): on 4 ranks of a (2, 2) mesh a chunk of 8
# takes the joint layout (2 candidates a rank, whole eval batch), a chunk
# of 6 the candidate-only one (3 a rank, each on half the batch:
# ``engine.chunk_layout``); then the 1-D mesh of 4
SHARDED_RUNS = (("mesh_2x2_chunk_8", (2, 2), 8),
                ("mesh_2x2_chunk_6", (2, 2), 6),
                ("mesh_4_chunk_8", (4,), 8))
SHARDED_KERNELS = ("masked_act_2d", "masked_act_2d_batched",
                   "masked_act_conv3x3", "masked_act_conv3x3_batched")
GPIPE_STAGES, GPIPE_MICRO, GPIPE_ROWS, GPIPE_WIDTH = 4, 8, 256, 1024


def sharded_bcd_config(model, chunk: int):
    """The ``bcd`` line's ``drc=100, rt=16``, 3 steps, no early exit (every
    trial evaluated and compared), the paper's removal moves."""
    from repro_torch.core import bcd
    total = model.relu_count()
    return bcd.BCDConfig(b_target=total - 100 * BCD_STEPS, drc=100, rt=16,
                         adt=-100.0, finetune_every_step=False, seed=0,
                         chunk_size=chunk, moves=("remove",))


def recorded_bcd(model, evaluator, eval_acc, cfg):
    """``run_bcd`` with every trial's reading kept, in sampling order."""
    from repro_torch.core import bcd, linearize, masks as M
    trials = []
    inner = evaluator.evaluate_staged

    def recording(staged):
        accs = inner(staged)
        trials.extend(float(a) for a in accs)
        return accs
    evaluator.evaluate_staged = recording
    masks0 = linearize.init_masks(model.mask_sites())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bcd.run_bcd(masks0, cfg, eval_acc, evaluator=evaluator)
    torch.cuda.synchronize()
    return dict(fingerprint=M.fingerprint(res.masks),
                steps=[[h.trials, h.found_early, h.best_drop,
                        h.budget_before, h.budget_after]
                       for h in res.history],
                trials=trials, wall_s=time.perf_counter() - t0)


def run_sharded_bcd_rank(rank, world, root, device="cuda", small=False):
    """One rank of ``sharded_bcd``: ResNet18's BCD on the sharded engine
    over each mesh of ``SHARDED_RUNS``, its layouts, readings and launches
    (each run's counts set to 0 just before it)."""
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sweep import make_bcd_evaluator
    result = dict(rank=rank, backend=dist.get_backend(), runs={})
    model, params, batch = make_model_and_batch(SEED)
    for label, shape, chunk in SHARDED_RUNS:
        mesh = mesh_lib.make_cand_batch_mesh(*shape) if len(shape) == 2 \
            else mesh_lib.make_candidate_mesh(shape[0])
        build.reset_launch_counts()
        ev, eval_acc, _ = make_bcd_evaluator(
            "sharded", model, batch, {"params": params}, chunk_size=chunk,
            rt=16, prefetch=0, fused_kernels=True, mesh=mesh)
        layouts = []
        choose = ev._chunk_sharding

        def logged(n, choose=choose, layouts=layouts):
            layouts.append(choose(n))
            return layouts[-1]
        ev._chunk_sharding = logged
        run = recorded_bcd(model, ev, eval_acc,
                           sharded_bcd_config(model, chunk))
        run.update(mesh=list(shape), coordinate=list(mesh.get_coordinate()),
                   chunk_layouts=[list(x) for x in layouts],
                   launches={k: v for k, v in counts().items() if v})
        result["runs"][label] = run
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return result


def same_result(got: dict, want: dict) -> bool:
    """The reference's ``_assert_same_result`` (``tests/test_bcd_parallel.
    py``): masks, trials and early exits equal, ``best_drop`` within
    1e-4, budgets equal."""
    if got["fingerprint"] != want["fingerprint"] or \
            len(got["steps"]) != len(want["steps"]):
        return False
    return all(g[:2] == w[:2] and abs(g[2] - w[2]) <= 1e-4
               and g[3:] == w[3:] for g, w in zip(got["steps"],
                                                  want["steps"]))


def run_gpipe_on_card():
    """``training.pp.gpipe_forward`` on the card, each stage a product and
    the silu gate (``ops.masked_act``, kernel 1), held against the stages
    applied in turn; both run the same kernels on the same rows."""
    from repro_torch.kernels import ops
    from repro_torch.training.pp import gpipe_forward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S, Mi, R, D = GPIPE_STAGES, GPIPE_MICRO, GPIPE_ROWS, GPIPE_WIDTH
    params = {"w": torch.randn((S, D, D), generator=gen, device="cuda")
              * D ** -0.5,
              "m": (torch.rand((S, D), generator=gen, device="cuda") < 0.5)
              .float()}
    micro = torch.randn((Mi, R, D), generator=gen, device="cuda")

    def body(p, x):
        return ops.masked_act(x @ p["w"], p["m"], kind="silu")
    before = counts()
    with torch.no_grad():
        got = gpipe_forward(body, params, micro)
        want = micro
        for s_ in range(S):
            want = torch.stack([body({"w": params["w"][s_],
                                      "m": params["m"][s_]}, x)
                                for x in want])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    launches = counts()["masked_act_2d"] - before["masked_act_2d"]
    if not torch.isfinite(got).all() or err > 1e-6 or launches == 0:
        fail(f"gpipe: max |pipeline - stages in turn| {err}, "
             f"{launches} gate launches")
    return dict(stages=S, microbatches=Mi, rows=R, width=D,
                max_abs_err=err, tolerance=1e-6, gate_launches=launches)


def run_world_of_one(model, params, batch):
    """``make_evaluator("sharded")`` in this process, a world of 1 with no
    launcher: a chunk's accuracies equal to the batched engine's."""
    from repro_torch.core import linearize, masks as M
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    stacked = M.sample_removal_blocks(np.random.default_rng(SEED), masks0,
                                      100, 8)
    accs = {}
    try:
        for backend in ("batched", "sharded"):
            ev, _, _ = make_bcd_evaluator(backend, model, batch,
                                          {"params": params}, chunk_size=8,
                                          rt=16, prefetch=0)
            accs[backend] = ev.evaluate(stacked)
        info = mesh_lib.process_info()
        import torch.distributed as dist
        backend_name = dist.get_backend()
    finally:
        mesh_lib.shutdown()
    if not np.array_equal(accs["sharded"], accs["batched"]):
        fail(f"sharded_bcd world of 1: {accs['sharded']} differ from "
             f"batched {accs['batched']}")
    return dict(process_info=list(info), backend=backend_name,
                accs=[float(a) for a in accs["sharded"]])


def sharded_bcd_want():
    """This process's side of ``sharded_bcd``, done before the ranks start
    their timed work: ResNet18's BCD on the batched engine for each chunk
    size of ``SHARDED_RUNS``, the runs the ranks are held to."""
    from repro_torch.launch.sweep import make_bcd_evaluator
    t0 = time.perf_counter()
    model, params, batch = make_model_and_batch(SEED)
    want = {}
    for chunk in sorted({c for _, _, c in SHARDED_RUNS}):
        ev, eval_acc, _ = make_bcd_evaluator(
            "batched", model, batch, {"params": params}, chunk_size=chunk,
            rt=16, prefetch=0, fused_kernels=True)
        want[chunk] = recorded_bcd(model, ev, eval_acc,
                                   sharded_bcd_config(model, chunk))
    return dict(model=model, params=params, batch=batch, want=want,
                seconds=time.perf_counter() - t0)


def judge_sharded_bcd(results, ctx, by_path):
    """Gates of ``sharded_bcd``: every rank's selections against the
    batched run's (``ctx``, :func:`sharded_bcd_want`), by the reference's
    standard, its trials read apart to the bit, its chunks' layouts (both
    the joint and the candidate-only one seen) and its launches; then the
    world of 1 and ``gpipe_forward`` in this process.  Nothing falls
    back."""
    model, params, batch, want = (ctx[k] for k in ("model", "params",
                                                   "batch", "want"))
    t_phase = time.perf_counter()
    runs, total = {}, {k: 0 for k in counts()}
    for label, shape, chunk in SHARDED_RUNS:
        ref = want[chunk]
        row = dict(mesh=list(shape), chunk_size=chunk,
                   batched_fingerprint=ref["fingerprint"][:16],
                   batched_wall_s=ref["wall_s"], ranks=[])
        layouts = set()
        for res in results:
            run = res["runs"][label]
            apart = [i for i, (a, b) in enumerate(zip(run["trials"],
                                                      ref["trials"]))
                     if a != b]
            if not same_result(run, ref):
                emit({"sharded_bcd_failed": dict(label=label, rank=res["rank"],
                                                 got=run, want=ref)})
                fail(f"sharded_bcd {label} rank {res['rank']}: selections "
                     "differ from the batched run's")
            missing = [k for k in SHARDED_KERNELS
                       if run["launches"].get(k, 0) == 0]
            if missing:
                fail(f"sharded_bcd {label} rank {res['rank']}: no launch of "
                     f"{missing}")
            layouts.update(lay for _, lay in run["chunk_layouts"])
            for k, v in run["launches"].items():
                total[k] += v
            row["ranks"].append(dict(
                rank=res["rank"], coordinate=run["coordinate"],
                wall_s=run["wall_s"], trials=len(run["trials"]),
                trials_apart_from_batched=apart,
                chunk_layouts=run["chunk_layouts"],
                launches={k: run["launches"].get(k, 0)
                          for k in SHARDED_KERNELS}))
        row["layouts"] = sorted(layouts)
        runs[label] = row
    seen = set().union(*(set(r["layouts"]) for r in runs.values()))
    if seen != {"joint", "cand"}:
        fail(f"sharded_bcd: layouts {sorted(seen)}, not both joint and "
             "cand")
    before = counts()
    one = run_world_of_one(model, params, batch)
    gpipe = run_gpipe_on_card()
    for k, v in counts().items():
        total[k] += v - before[k]
    by_path["sharded_bcd"] = total
    del model, params
    torch.cuda.empty_cache()
    ranks_seconds = max(r["rank_s"] for r in results)
    return dict(model="resnet18", batch=128, relus=557056, drc=100, rt=16,
                steps=BCD_STEPS, adt=-100.0, world=SHARDED_WORLD,
                backend=results[0]["backend"], ranks_seconds=ranks_seconds,
                runs=runs, world_of_one=one, gpipe=gpipe,
                batched_s=ctx["seconds"],
                seconds=ctx["seconds"] + ranks_seconds +
                time.perf_counter() - t_phase)


# ---------------------------------------------- sharded serving and training
#
# Two phases on 4 ranks of one ``gloo`` group sharing the card, each rank a
# child process of this script (``--sharded-phase serve,train``), the same
# spawn that runs ``sharded_bcd`` first: the models tensor-parallel over
# "model" and data-parallel (ZeRO-3 in training) over "data"
# (``models.lm.LM`` on a mesh).  4 ranks share one card, so these are
# correctness runs, not a speed-up.  The ranks start their work once this
# process has done its own side of every phase (the batched BCD runs, the
# one-process loops and forwards, the one-process first step), so that no
# rank's timing shares the card with it; only the one-process restore of
# the final checkpoint overlaps the ranks' last two parts (the
# uninterrupted run and the (4, 1) restore).

# serving: StableLM-2-1.6B at full width and all 24 layers, float32, a
# ``ServeLoop`` of the ``serve`` line's two budgets, 4 slots of 1024 tokens,
# 16 requests of 4-100 tokens bucketed to 16, 4 new tokens each (the
# ``serve`` line's 16 cut to 4 for the script's time: a tick costs 0.2-1 s
# with 51 ``gloo`` reductions of 2-6 ms each across 4 processes), on each
# mesh; RWKV-6 3B at full width on its LM path's 8 of 32 repeats, an
# exact-length loop of the ``serve`` line's prompts, on (1, 4).  Each
# decode tick of the drive is timed (synchronised around it) with the
# collectives it makes.
SHARDED_SERVE_MESHES = ((1, 4), (2, 2))
SHARDED_SERVE_MAX_LEN = 1024
SHARDED_SERVE_MAX_NEW = 4
SHARDED_RWKV_MESH = (1, 4)
# training: StableLM-2-1.6B at full width in its own bfloat16, 2 of 24
# layers (the checkpoints: 1.84 GB each; at 4 layers, 2.46 GB each, the
# phase took 126 s on one H100, over its budget), the launcher on (2, 2)
# for 4 steps of 8 x 128 tokens under the supervisor, a failure injected at
# step 2 (restart from the step-2 checkpoint); the uninterrupted run on
# the same mesh; then the final checkpoint restored onto (4, 1) and onto
# one process
SHARDED_TRAIN_LAYERS = 2
SHARDED_TRAIN_FLAGS = ("--arch", "stablelm_1p6b", "--steps", "4",
                       "--global-batch", "8", "--seq", "128", "--mesh", "2,2",
                       "--ckpt-every", "2")
SHARDED_TRAIN_FAIL_AT = 2
SHARDED_F32_TOL = 1e-4          # float32 (2, 2) step vs one process
# ... an SGD step at learning rate 1 (clip 1.0): at the launcher's lr an
# entry of a full-width leaf moves by less than 1e-4, so the leaves' gate
# alone could not see a wrong gradient; here each leaf's update must also
# be within 2 % of one process's (its largest entries, as
# tests/test_torch_sharded_train.py holds the CPU's), every leaf must move,
# and the grad norm that sets the clip must agree
SHARDED_F32_LR = 1.0
SHARDED_F32_UPDATE_REL = 0.02


class WholeLogits:
    """A model on a mesh whose ``forward`` returns whole logits on every
    rank (the vocabulary blocks gathered), for the serve phase's checks of
    one sequence at a time."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def forward(self, params, masks, tokens, **kw):
        from repro_torch.training import serve as serve_lib
        return serve_lib.gather_logits(
            self.model.forward(params, masks, tokens, **kw), self.model,
            tokens.shape[0])


def sharded_stablelm_cfg(small: bool):
    from repro_torch.configs import get_config
    cfg = get_config("stablelm_1p6b")
    return cfg.reduced() if small else cfg


def sharded_rwkv_cfg(small: bool):
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6_3b")
    return cfg.reduced() if small else dataclasses.replace(
        cfg, n_layers=LM_PATHS[1].layers)


def sharded_serve_loop(model, params, store, kind, mesh, device):
    """The serve phase's loop of ``kind`` ("stablelm" or "rwkv") on
    ``mesh`` (None: one process), driven; returns (loop, requests)."""
    from repro_torch.launch import serve_loop
    classes = [serve_loop.SLOClass(
        f"c{i}", n, SHARDED_SERVE_MAX_NEW if kind == "stablelm" else 4)
        for i, n in enumerate(store.names)]
    if kind == "stablelm":
        loop = serve_loop.ServeLoop(
            model, params, store, classes, slots=SERVE_SLOTS,
            max_len=SHARDED_SERVE_MAX_LEN, prompt_bucket=16, mesh=mesh,
            device=device, keep_logits=True)
        prompts = serve_prompts(SEED, SERVE_REQUESTS, 4, 100,
                                model.cfg.vocab)
    else:
        loop = serve_loop.ServeLoop(
            model, params, store, classes, slots=SERVE_SLOTS,
            max_len=RWKV_LOOP_MAX_LEN, prompt_bucket=None, mesh=mesh,
            device=device, keep_logits=True)
        prompts = [np.random.default_rng(SEED + 2 + i).integers(
            0, model.cfg.vocab, n) for i, n in enumerate(RWKV_LOOP_PROMPTS)]
    ticks = timed_ticks(loop, device) if mesh is not None else None
    reqs = drive_loop(loop, prompts, [c.name for c in classes])
    if [r.state for r in reqs] != ["served"] * len(reqs):
        fail(f"sharded_serve: {kind} states {[r.state for r in reqs]}")
    return loop, reqs, ticks


def timed_ticks(loop, device):
    """Wrap the loop's decode step: each tick's wall-clock (synchronised
    before and after) and ``all_reduce`` calls and bytes on this rank,
    with the slots live at it; returns the list it fills."""
    from repro_torch.core import spmd
    inner, out = loop._decode, []

    def decode(params, masks, tok, cache, cache_len, ties=True):
        sync(device)
        before = spmd.collective_counts()
        t0 = time.perf_counter()
        got = inner(params, masks, tok, cache, cache_len, ties=ties)
        sync(device)
        after = spmd.collective_counts()
        out.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                        live=int(sum(ln.live.sum()
                                     for ln in loop.lanes.values()
                                     if ln.cache is cache)),
                        calls=after["calls"] - before["calls"],
                        bytes=after["bytes"] - before["bytes"]))
        return got
    loop._decode = decode
    return out


def tick_summary(ticks, slots):
    """The drive's decode ticks with every slot live: wall-clock and the
    collectives a tick makes (the same each tick)."""
    full = [t for t in ticks if t["live"] == slots] or ticks
    ms = [t["ms"] for t in full]
    return dict(slots_live=slots if full is not ticks else None,
                ticks=len(full), of=len(ticks), ms_mean=float(np.mean(ms)),
                ms_median=float(np.median(ms)), ms_min=float(np.min(ms)),
                ms_max=float(np.max(ms)),
                all_reduce_per_tick=sorted({t["calls"] for t in full}),
                all_reduce_bytes_per_tick=sorted({t["bytes"] for t in full}))


def uncached_served(model, params, store, reqs, pad, device):
    """The uncached forward's logits at every served position of every
    request (as :func:`served_consistency` takes them), in request order:
    one batched forward per mask set, each sequence zero-padded at its end
    to the set's longest (a multiple of ``pad``; exact, the models are
    causal)."""
    rows = {}
    with torch.no_grad():
        for name in sorted({r.mask_set for r in reqs}):
            mine = [r for r in reqs if r.mask_set == name]
            seqs = [np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int64)
                    for r in mine]
            width = -(-max(len(s) for s in seqs) // pad) * pad
            toks = np.zeros((len(seqs), width), np.int64)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = s
            out = model.forward(params, store.select(name),
                                torch.from_numpy(toks).to(device), ties=False)
            for i, (r, s) in enumerate(zip(mine, seqs)):
                rows[r.rid] = out[i, len(r.prompt) - 1:len(s)].float().cpu()
    return torch.cat([rows[r.rid] for r in reqs])


def served_check(model, params, store, reqs, pad, device):
    """Every served token against the uncached forward's argmax where its
    top-2 margin exceeds ``SERVE_MARGIN`` and every kept logit within
    ``LM_LOGIT_TOL`` of that forward (:func:`judge_served`), the uncached
    forward batched (:func:`uncached_served`)."""
    full = uncached_served(model, params, store, reqs, pad, device)
    kept = torch.cat([torch.stack(r.logits).float().cpu() for r in reqs])
    toks = torch.tensor([t for r in reqs for t in r.tokens])
    worst, checked, matched, near = judge_served(kept, full, toks)
    if matched != checked or not worst <= LM_LOGIT_TOL:
        fail(f"sharded_serve: {checked - matched} of {checked} served "
             f"tokens are not the uncached argmax, or cached vs uncached "
             f"logits differ by {worst} > {LM_LOGIT_TOL}")
    return dict(max_abs_diff_cached_vs_uncached=worst, logit_tol=LM_LOGIT_TOL,
                margin=SERVE_MARGIN, tokens_checked=checked,
                tokens_matched=matched, tokens_within_margin=near)


def sharded_one_process(kind, root, device="cuda", small=False):
    """The one-process side of a served model: its loop's decisions
    fingerprint and tokens (JSON) and the one-process uncached forward's
    logits at the served positions (``.npy``), for the ranks to read."""
    from repro_torch.launch import serve_loop
    spec = LM_PATHS[0] if kind == "stablelm" else LM_PATHS[1]
    cfg = sharded_stablelm_cfg(small) if kind == "stablelm" \
        else sharded_rwkv_cfg(small)
    model, params = make_lm(SEED, spec, device, cfg=cfg)
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS, seed=SEED,
                                           device=device)
    loop, reqs, _ = sharded_serve_loop(model, params, store, kind, None,
                                       device)
    full = uncached_served(model, params, store, reqs, spec.pad, device)
    np.save(os.path.join(root, f"{kind}_uncached.npy"), full.numpy())
    # the JSON last, and whole: the ranks read both once it appears
    tmp = os.path.join(root, f"{kind}_one.tmp")
    with open(tmp, "w") as f:
        json.dump(dict(fingerprint=loop.stats()["decisions_sha256"],
                       tokens=[list(map(int, r.tokens)) for r in reqs]), f)
    os.rename(tmp, os.path.join(root, f"{kind}_one.json"))
    del model, params, store, loop, reqs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sharded_serve_case(kind, shape, root, device, small):
    """One served model on one mesh, on this rank: the loop with counts set
    to 0 just before the drive and read just after, its decisions
    fingerprint and tokens against the one-process loop's, every served
    token against the sharded uncached forward's argmax and its logits
    against that forward (:func:`served_consistency`), and against the
    one-process uncached forward on the card within ``LM_LOGIT_TOL``."""
    from repro_torch.core import spmd
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib, serve_loop
    from repro_torch.training import serve as serve_lib
    spec = LM_PATHS[0] if kind == "stablelm" else LM_PATHS[1]
    cfg = sharded_stablelm_cfg(small) if kind == "stablelm" \
        else sharded_rwkv_cfg(small)
    mesh = mesh_lib.make_host_mesh(*shape, device=device)
    model, full = make_lm(SEED, spec, device, cfg=cfg)
    params = serve_lib.shard_params(full, model, mesh)
    del full
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS, seed=SEED,
                                           device=device)
    build.reset_launch_counts()
    spmd.reset_collective_counts()
    t0 = time.perf_counter()
    loop, reqs, ticks = sharded_serve_loop(model, params, store, kind, mesh,
                                           device)
    sync(device)
    drive_s = time.perf_counter() - t0
    launches = counts()
    coll = spmd.collective_counts()
    # written by the parent before the ranks began
    with open(os.path.join(root, f"{kind}_one.json")) as f:
        one = json.load(f)
    fp = loop.stats()["decisions_sha256"]
    toks = [list(map(int, r.tokens)) for r in reqs]
    tpm = WholeLogits(model.on_mesh(mesh))
    check = served_check(tpm, params, store, reqs, spec.pad, device)
    want = torch.from_numpy(np.load(os.path.join(root,
                                                  f"{kind}_uncached.npy")))
    kept = torch.cat([torch.stack(r.logits).float().cpu() for r in reqs])
    vs_one = float((kept - want).abs().max()) if kept.shape == want.shape \
        else float("inf")
    tick = tick_summary(ticks, loop.slots)
    return dict(
        mesh=list(shape), model=model.cfg.name, layers=model.cfg.n_layers,
        slots=loop.slots, max_len=loop.max_len, requests=len(reqs),
        drive_s=drive_s, decisions_sha256=fp,
        decisions_equal_one_process=fp == one["fingerprint"],
        tokens_equal_one_process=toks == one["tokens"],
        vs_one_process_uncached=dict(max_abs_diff=vs_one, tol=LM_LOGIT_TOL),
        vs_sharded_uncached=check, decode_tick=tick,
        all_reduce_calls_in_drive=coll["calls"],
        launches={k: v for k, v in launches.items() if v},
        peak_bytes=torch.cuda.max_memory_allocated()
        if torch.device(device).type == "cuda" else None)


def run_sharded_serve_rank(rank, world, root, device="cuda", small=False):
    """One rank of ``sharded_serve``: StableLM-2-1.6B on each mesh of
    ``SHARDED_SERVE_MESHES``, RWKV-6 3B on ``SHARDED_RWKV_MESH``."""
    out = dict(rank=rank, cases=[])
    for shape in SHARDED_SERVE_MESHES:
        out["cases"].append(sharded_serve_case("stablelm", shape, root,
                                               device, small))
    out["cases"].append(sharded_serve_case("rwkv", SHARDED_RWKV_MESH, root,
                                           device, small))
    return out


def sharded_grads(model, opt, mesh, state, batch, masks):
    """The loss and the whole-leaf gradients of one sharded step's
    backward (what ``jit_train_step`` computes before its update, ZeRO-3
    on), the same on every rank: ``(loss, [gradients in tree_leaves
    order])``."""
    from repro_torch.core import spmd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    data, m = (mesh_lib.axis(mesh, n).size for n in ("data", "model"))
    tpm = LM(model.cfg, mesh)
    held = train.held_state_specs(tpm, opt, data, m)
    if data > 1:
        tpm.fsdp_specs = held["params"]
    lo, hi = tpm.data_axis.span(batch["tokens"].shape[0])
    loss_fn = train.make_loss_fn(tpm, train.TrainStepCfg(remat=True))
    with train.deterministic():
        loss, g = train.loss_and_grads(loss_fn, state["params"], masks,
                                       {k: v[lo:hi] for k, v in
                                        batch.items()})
    specs = train._spec_leaves(held["params"])
    g = train._sum_over_data(opt_lib.tree_leaves(g), specs, tpm.data_axis)
    whole = mesh_lib.gather_tree(opt_lib.tree_unflatten(state["params"], g),
                                 held["params"], mesh)
    return float(spmd.all_reduce_sum(loss, tpm.data_axis)), \
        [t.cpu() for t in opt_lib.tree_leaves(whole)]


def one_process_grads(model, params, batch, masks, device):
    """One process's loss and gradients of the same step (the card's)."""
    from repro_torch.training import optimizer as opt_lib, train
    loss_fn = train.make_loss_fn(model, train.TrainStepCfg(remat=True))
    with train.deterministic():
        loss, g = train.loss_and_grads(loss_fn, params, masks, batch)
    return float(loss), [t.cpu() for t in opt_lib.tree_leaves(g)]


def sharded_train_setup(root, device="cuda", small=False):
    """What the ranks of ``sharded_train`` and this process's side of its
    first step share: the launcher's arguments, the config cut to
    ``SHARDED_TRAIN_LAYERS``, the model, AdamW as the launcher builds it,
    full masks, ``batch(i)`` and ``fresh(model, opt)``."""
    import types
    from repro_torch.core import linearize, masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.launch import train as launch
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    args = launch.parse_args(list(SHARDED_TRAIN_FLAGS) + [
        "--ckpt-dir", os.path.join(root, "ck"), "--device", device])
    cfg = launch.make_config(args)
    cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16") if small \
        else dataclasses.replace(cfg, n_layers=SHARDED_TRAIN_LAYERS)
    model = LM(cfg)
    mt = MarkovTokens(cfg.vocab, seed=0)

    def batch(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in mt.batch(args.global_batch, args.seq, i).items()}

    def fresh(m, o):
        gen = torch.Generator(device=device).manual_seed(0)
        return train.make_state(m, o, gen, device)
    return types.SimpleNamespace(
        args=args, cfg=cfg, model=model,
        opt=opt_lib.adamw(lr=args.lr, grad_clip=1.0,
                          schedule=opt_lib.cosine(args.lr, args.steps)),
        masks=M.as_device(linearize.init_masks(model.mask_sites()), device),
        batch=batch, fresh=fresh)


def sharded_first_step_one_process(root, device="cuda", small=False):
    """This process's side of ``sharded_train``'s first step, done before
    the ranks start their timed work: one process's loss and gradients on
    the card, in the model's bfloat16 and in float32 from the same
    parameters upcast, saved under ``root`` for rank 0 to hold its sharded
    gradients to (``bf16_grad_rule``)."""
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib
    s = sharded_train_setup(root, device, small)
    params = s.fresh(s.model, s.opt)["params"]
    names = opt_lib.tree_leaves(_leaf_names(params))
    loss, g_1 = one_process_grads(s.model, params, s.batch(0), s.masks,
                                  device)
    m32 = LM(dataclasses.replace(s.cfg, dtype="float32"))
    p32 = opt_lib.tree_map(lambda t: t.float(), params)
    del params
    _, g_32 = one_process_grads(m32, p32, s.batch(0), s.masks, device)
    del p32
    tmp = os.path.join(root, "first_step_one.tmp")
    torch.save(dict(loss=loss, names=names, g_1=g_1, g_32=g_32), tmp)
    os.rename(tmp, os.path.join(root, "first_step_one.pt"))
    del g_1, g_32
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_sharded_train_rank(rank, world, root, device="cuda", small=False):
    """One rank of ``sharded_train`` (see the constants above): the first
    step's loss and gradients on (2, 2) against one process's (computed
    by the parent, :func:`sharded_first_step_one_process`), a float32 SGD
    step on (2, 2) against one process's (rank 0 computes that), the
    launcher under the supervisor with a failure against the
    uninterrupted run, and the final checkpoint restored onto (4, 1)."""
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib, train as launch
    from repro_torch.models.lm import LM
    from repro_torch.training import checkpoint, ft, optimizer as opt_lib
    from repro_torch.training import train
    s = sharded_train_setup(root, device, small)
    args, cfg, model, opt = s.args, s.cfg, s.model, s.opt
    masks, batch, fresh = s.masks, s.batch, s.fresh
    mesh = launch.make_mesh(args, device)
    held = train.held_state_specs(model, opt, 2, 2)
    out = dict(rank=rank, mesh=[2, 2], model=cfg.name, dtype=cfg.dtype,
               layers=cfg.n_layers, flags=list(SHARDED_TRAIN_FLAGS))
    laps = {}

    # ---- the first step's loss and gradients against one process's
    t0 = time.perf_counter()
    state = train.shard_state(fresh(model, opt), model, opt, mesh)
    loss_s, g_s = sharded_grads(model, opt, mesh, state, batch(0), masks)
    del state
    if rank == 0:
        one = torch.load(os.path.join(root, "first_step_one.pt"))
        rule, ok = bf16_grad_rule(one["names"], g_s, one["g_1"],
                                  one["g_32"])
        loss_rel = abs(loss_s - one["loss"]) / abs(one["loss"])
        out["first_step"] = dict(
            loss_sharded=loss_s, loss_one_process=one["loss"],
            loss_rel=loss_rel, loss_tol=LM_TRAIN_BF16_LOSS_REL, grads=rule,
            grads_ok=ok,
            yardstick="the one-process float32 gradient on the card of the "
                      "same parameters, upcast; the one-process bfloat16 "
                      "gradient in the rule's place of the CPU's")
        del one
    del g_s
    laps["first_step"] = time.perf_counter() - t0
    dist.barrier()

    # ---- a float32 SGD step on (2, 2) against one process's: at
    # SHARDED_F32_LR every leaf's update is far above its rounding, so a
    # gradient zeroed, halved, doubled or clipped by a wrong norm shows
    t0 = time.perf_counter()
    m32 = LM(dataclasses.replace(cfg, dtype="float32"))
    sgd = opt_lib.sgd(lr=SHARDED_F32_LR, momentum=0.9, grad_clip=1.0)
    tcfg = train.TrainStepCfg(remat=True)
    state = train.shard_state(fresh(m32, sgd), m32, sgd, mesh)
    state, met = train.jit_train_step(m32, sgd, mesh, tcfg)(state, batch(0),
                                                           masks)
    whole = mesh_lib.gather_tree(
        state["params"], train.held_state_specs(m32, sgd, 2, 2)["params"],
        mesh)
    del state
    if rank == 0:
        start = fresh(m32, sgd)
        p0 = opt_lib.tree_leaves(start["params"])   # the step replaces them
        one, m1 = train.make_train_step(m32, sgd, tcfg)(start, batch(0),
                                                        masks)
        errs, rel, moved = [], [], []
        for a, b, z in zip(opt_lib.tree_leaves(whole),
                           opt_lib.tree_leaves(one["params"]), p0):
            errs.append(float((a - b).abs().max()))
            moved.append(float((b - z).abs().max()))
            rel.append(float(((a - z) - (b - z)).abs().max()) /
                       max(moved[-1], 1e-30))
        names = opt_lib.tree_leaves(_leaf_names(one["params"]))
        out["float32_step"] = dict(
            optimizer="sgd", lr=SHARDED_F32_LR,
            loss_sharded=float(met["loss"]),
            loss_one_process=float(m1["loss"]),
            grad_norm_sharded=float(met["grad_norm"]),
            grad_norm_one_process=float(m1["grad_norm"]),
            max_abs_leaf_diff=max(errs), tol=SHARDED_F32_TOL,
            max_abs_update=max(moved),
            least_leaf_max_update=min(moved),
            least_moved_leaf=names[int(np.argmin(moved))],
            max_update_rel_diff=max(rel),
            update_rel_tol=SHARDED_F32_UPDATE_REL,
            worst_update_leaf=names[int(np.argmax(rel))])
        del one, start, p0
    del whole
    laps["float32_step"] = time.perf_counter() - t0
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # ---- the launcher under the supervisor, a failure injected; counts
    # set to 0 just before, read just after
    import io
    DISK.phase = "sharded_train"
    build.reset_launch_counts()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = launch.run(args, cfg, device, injector=ft.FailureInjector(
            fail_at_steps=(SHARDED_TRAIN_FAIL_AT,)))
    sync(device)
    laps["launcher_run"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in counts().items() if v}
    final = mesh_lib.gather_tree(got["result"]["state"], held, mesh)

    # ---- the uninterrupted run on the same mesh (no checkpoints)
    t0 = time.perf_counter()
    step = train.jit_train_step(model, opt, mesh, train.TrainStepCfg(
        remat=True, dp_axes=("data",)))
    state = train.shard_state(fresh(model, opt), model, opt, mesh)
    losses = []
    for i in range(args.steps):
        state, met = step(state, batch(i), masks)
        losses.append(float(met["loss"]))
    plain = mesh_lib.gather_tree(state, held, mesh)
    del state
    laps["uninterrupted"] = time.perf_counter() - t0
    a, b = _state_leaves(final), _state_leaves(plain)
    out["interrupted"] = dict(
        restarts=got["result"]["restarts"], losses=got["losses"],
        uninterrupted_losses=losses, step_ms=got["step_ms"],
        losses_finite=bool(np.isfinite(got["losses"]).all()),
        losses_equal=got["losses"] == losses,
        state_equal_bits=len(a) == len(b) and all(
            ka == kb and _same_bits(x, y) for (ka, x), (kb, y) in zip(a, b)))
    del plain

    # ---- the final checkpoint restored onto (4, 1)
    t0 = time.perf_counter()
    mesh41 = mesh_lib.make_host_mesh(4, 1, device=device)
    held41 = train.held_state_specs(model, opt, 4, 1)
    # no sha256 pass here: every restored leaf is held to the saved one
    # bit for bit (the one-process restore below verifies the files)
    restored, at = checkpoint.restore(
        got["result"]["state"], args.ckpt_dir, device=device, verify=False,
        shardings=mesh_lib.Shardings(mesh41, held41))
    back = _state_leaves(mesh_lib.gather_tree(restored, held41, mesh41))
    out["restore_4x1"] = dict(step=at, equal_bits=len(back) == len(a) and all(
        ka == kb and _same_bits(x, y) for (ka, x), (kb, y) in zip(back, a)))
    laps["restore_4x1"] = time.perf_counter() - t0
    if rank == 0:
        out["digests"] = {k: _digest(t) for k, t in a}
        out["checkpoint_bytes"] = sum(DISK.by_phase.values())
    out["seconds"] = laps
    out["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else None
    out["last_lines"] = printed.getvalue().splitlines()[-2:]
    return out


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


SHARDED_PHASES = ("bcd", "serve", "family", "train")
# each phase's share of the spawn's time limit
SHARDED_TIMEOUT_S = {"bcd": 180, "serve": 420, "family": 240, "train": 480}


def run_rank_phase(phases, rank, world, store, out, root, device="cuda",
                   small=False):
    """A child rank of the sharded phases (``phases``: some of
    ``SHARDED_PHASES``, comma-separated, run in that order): the process
    group through ``store``, a wait until the parent has done its side of
    every phase (``parent_ready`` under ``root``), then each phase's rank
    function; the results written to ``out`` as JSON, by phase."""
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    if torch.device(device).type == "cuda":
        build.load()
    mesh_lib.init_process_group(
        device, store=dist.FileStore(store, world), rank=rank, world=world,
        timeout_s=SHARDED_RANK_TIMEOUT_S)
    DISK.install()
    wait_for_file(os.path.join(root, "parent_ready"), None,
                  SHARDED_RANK_TIMEOUT_S)
    fns = {"bcd": run_sharded_bcd_rank, "serve": run_sharded_serve_rank,
           "family": run_sharded_family_rank,
           "train": run_sharded_train_rank}
    result = {}
    for phase in phases.split(","):
        t0 = time.perf_counter()
        result[phase] = fns[phase](rank, world, root, device, small)
        result[phase]["rank_s"] = time.perf_counter() - t0
    dist.barrier()
    mesh_lib.shutdown()
    with open(out, "w") as f:
        json.dump(result, f)


def wait_for_file(path, procs, timeout):
    """Block until ``path`` exists; fail if a rank of ``procs`` (None in
    a rank) ended badly or ``timeout`` seconds pass first."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if procs and any(p.poll() not in (None, 0) for p in procs):
            return False
        if time.perf_counter() - t0 > timeout:
            fail(f"sharded: {path} did not appear within {timeout} s")
        time.sleep(0.2)
    return True


def start_ranks(phases, root, device="cuda", small=False):
    """``SHARDED_WORLD`` child ranks of this script for ``phases``, a
    ``FileStore`` under ``root``; returns the processes and their result
    files (:func:`finish_ranks` collects them)."""
    store = os.path.join(root, "store")
    outs = [os.path.join(root, f"rank{r}.json")
            for r in range(SHARDED_WORLD)]
    extra = (["--sharded-device", device] if device != "cuda" else []) + \
        (["--sharded-small"] if small else [])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-phase",
         ",".join(phases), "--sharded-rank", str(r), "--sharded-world",
         str(SHARDED_WORLD), "--sharded-store", store, "--sharded-out",
         outs[r], "--sharded-root", root] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(SHARDED_WORLD)]
    return procs, outs, time.perf_counter()


def finish_ranks(started, timeout, what):
    """Wait for the ranks of :func:`start_ranks`, each under ``timeout``
    seconds from the start; any rank that fails or hangs fails the run
    (its log printed), every child is ended.  Returns the ranks' results,
    in rank order."""
    procs, outs, t0 = started
    logs, bad = {}, []
    try:
        for r, p in enumerate(procs):
            left = timeout - (time.perf_counter() - t0)
            try:
                logs[r], _ = p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                bad.append(f"rank {r} ran past {timeout} s")
                break
            if p.returncode != 0:
                bad.append(f"rank {r} exited {p.returncode}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    if bad:
        for r, text in logs.items():
            print(f"== {what} rank {r}\n{text[-3000:]}", file=sys.stderr)
        fail(f"{what}: {'; '.join(bad)}")
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def sum_launches(parts, by_path, path):
    total = {k: 0 for k in counts()}
    for part in parts:
        for case in part.get("cases", [part]):
            for k, v in case["launches"].items():
                total[k] += v
    by_path[path] = total


def run_sharded_phases(by_path, phases=SHARDED_PHASES, device="cuda",
                       small=False):
    """The ``sharded_bcd``, ``sharded_serve``, sharded MoE and hybrid
    (``family``) and ``sharded_train`` phases (those of ``phases``) on one
    spawn of 4 ranks (:func:`run_rank_phase`).  While the ranks start,
    this process does its side of each phase: the batched BCD runs, the
    one-process loops and uncached forwards the serving ranks are held
    to, the MoE's and the hybrid's one-process serving, and the
    one-process first step; then it lets the ranks go, and restores the
    training ranks' final checkpoint onto one process.  Returns each
    phase's lines (:func:`judge_sharded_bcd`, :func:`judge_sharded_serve`,
    :func:`judge_sharded_family`, :func:`judge_sharded_train`); each phase
    fails on its own."""
    import shutil
    root = os.path.join(HERE, "build", f"sharded_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_all = time.perf_counter()
    started = start_ranks(phases, root, device, small)
    t0 = time.perf_counter()
    bcd = sharded_bcd_want() if "bcd" in phases else None
    if "serve" in phases:
        for kind in ("stablelm", "rwkv"):
            sharded_one_process(kind, root, device, small)
    if "family" in phases:
        sharded_family_one_process(root, device, small)
    if "train" in phases:
        sharded_first_step_one_process(root, device, small)
    parent_s = time.perf_counter() - t0
    with open(os.path.join(root, "parent_ready"), "w"):
        pass
    restore = sharded_restore_one_process(root, started[0], device, small) \
        if "train" in phases else None
    results = finish_ranks(started, sum(SHARDED_TIMEOUT_S[p]
                                        for p in phases), "sharded")
    ranks_s = time.perf_counter() - t_all
    shutil.rmtree(root, ignore_errors=True)
    lines = {}
    if "bcd" in phases:
        lines["sharded_bcd"] = judge_sharded_bcd(
            [r["bcd"] for r in results], bcd, by_path)
    if "serve" in phases:
        lines["sharded_serve"] = judge_sharded_serve(
            [r["serve"] for r in results], by_path, device)
    if "family" in phases:
        lines.update(judge_sharded_family([r["family"] for r in results],
                                          by_path, device))
    if "train" in phases:
        lines["sharded_train"] = judge_sharded_train(
            [r["train"] for r in results], by_path, device, restore)
    for line in lines.values():
        line["parent_before_ranks_s"] = parent_s
        line["ranks_spawn_to_end_s"] = ranks_s
    return lines


def judge_sharded_serve(parts, by_path, device):
    """Gates of ``sharded_serve``: every rank's decisions fingerprint and
    tokens equal to the one-process loop's, every served token the sharded
    uncached argmax (where the top-2 margin exceeds ``SERVE_MARGIN``) and
    every served logit within ``LM_LOGIT_TOL`` of the sharded and of the
    one-process uncached forward (checked in the ranks), and each rank
    launching the path's kernels."""
    for res in parts:
        for case in res["cases"]:
            where = f"sharded_serve {case['model']} {case['mesh']} " \
                f"rank {res['rank']}"
            if not (case["decisions_equal_one_process"] and
                    case["tokens_equal_one_process"]):
                fail(f"{where}: decisions or tokens differ from the "
                     "one-process loop's")
            if not case["vs_one_process_uncached"]["max_abs_diff"] <= \
                    LM_LOGIT_TOL:
                fail(f"{where}: served logits vs the one-process uncached "
                     f"forward: {case['vs_one_process_uncached']}")
            missing = [k for k in PATH_KERNELS["sharded_serve"]
                       if case["launches"].get(k, 0) == 0 and
                       not (k == "rwkv6_scan" and
                            case["model"].startswith("stablelm"))]
            if missing and torch.device(device).type == "cuda":
                fail(f"{where}: no launch of {missing}")
    sum_launches(parts, by_path, "sharded_serve")
    return dict(world=SHARDED_WORLD, backend="gloo",
                note="4 ranks share one card: correctness runs, not a "
                     "speed-up",
                seconds=max(r["rank_s"] for r in parts),
                ranks=[dict(rank=r["rank"], cases=r["cases"])
                       for r in parts])


def sharded_restore_one_process(root, procs, device, small):
    """Once the training ranks' launcher has written its final checkpoint,
    that checkpoint restored onto this one process (files verified
    against their sha256), each leaf's raw bytes digested."""
    from repro_torch.training import checkpoint
    ck = os.path.join(root, "ck")
    steps = int(SHARDED_TRAIN_FLAGS[SHARDED_TRAIN_FLAGS.index("--steps") + 1])
    if not wait_for_file(os.path.join(ck, f"step_{steps:08d}"), procs,
                         sum(SHARDED_TIMEOUT_S.values())):
        return None
    t0 = time.perf_counter()
    tree, step = checkpoint.restore(sharded_train_template(small), ck,
                                    steps, device=device)
    digests = {k: _digest(t) for k, t in _state_leaves(tree)}
    del tree
    return dict(step=step, digests=digests, seconds=time.perf_counter() - t0)


def _f32_step_ok(f32) -> bool:
    """sharded_train's float32 gates: every leaf within SHARDED_F32_TOL,
    loss and grad norm within it relatively, each leaf's update within
    SHARDED_F32_UPDATE_REL of one process's, every leaf moved."""
    return (f32["max_abs_leaf_diff"] <= SHARDED_F32_TOL and
            abs(f32["loss_sharded"] - f32["loss_one_process"]) <=
            SHARDED_F32_TOL * abs(f32["loss_one_process"]) and
            abs(f32["grad_norm_sharded"] - f32["grad_norm_one_process"]) <=
            SHARDED_F32_TOL * abs(f32["grad_norm_one_process"]) and
            f32["max_update_rel_diff"] <= SHARDED_F32_UPDATE_REL and
            f32["least_leaf_max_update"] > 0)


def judge_sharded_train(parts, by_path, device, restore):
    """Gates of ``sharded_train``: the first step's loss and gradients by
    the bfloat16 rule, the float32 step's leaves within ``SHARDED_F32_TOL``
    and its loss and grad norm within it relatively, every leaf moved by
    it and each leaf's update within ``SHARDED_F32_UPDATE_REL`` of one
    process's (its largest entries), finite
    losses, the interrupted run equal to the uninterrupted one to the bit,
    every restored leaf equal to the saved one to the bit, on (4, 1) and
    on one process."""
    r0 = parts[0]
    first, f32 = r0["first_step"], r0["float32_step"]
    if not (first["grads_ok"] and first["loss_rel"] <= first["loss_tol"]):
        fail(f"sharded_train: first step vs one process: {first}")
    if not _f32_step_ok(f32):
        fail(f"sharded_train: float32 step vs one process: {f32}")
    for res in parts:
        it = res["interrupted"]
        if not (it["losses_finite"] and it["losses_equal"] and
                it["state_equal_bits"] and it["restarts"] == 1):
            fail(f"sharded_train rank {res['rank']}: interrupted vs "
                 f"uninterrupted: {it}")
        if not res["restore_4x1"]["equal_bits"]:
            fail(f"sharded_train rank {res['rank']}: the (4, 1) restore "
                 "differs from the saved state")
        missing = [k for k in PATH_KERNELS["sharded_train"]
                   if res["launches"].get(k, 0) == 0]
        if missing and torch.device(device).type == "cuda":
            fail(f"sharded_train rank {res['rank']}: no launch of {missing}")
    if restore is None or restore["digests"] != r0["digests"]:
        fail("sharded_train: the one-process restore differs from the saved "
             "state")
    DISK.by_phase["sharded_train"] = DISK.by_phase.get(
        "sharded_train", 0) + r0["checkpoint_bytes"]
    sum_launches(parts, by_path, "sharded_train")
    return dict(world=SHARDED_WORLD, backend="gloo",
                note="4 ranks share one card: correctness runs, not a "
                     "speed-up",
                rank0={k: v for k, v in r0.items() if k != "digests"},
                ranks=[dict(rank=r["rank"], seconds=r["seconds"],
                            peak_bytes=r["peak_bytes"],
                            interrupted=r["interrupted"]["state_equal_bits"],
                            restore_4x1=r["restore_4x1"])
                       for r in parts],
                restore_one_process=dict(step=restore["step"],
                                         equal_bits=True,
                                         seconds=restore["seconds"]),
                checkpoint_bytes=r0["checkpoint_bytes"],
                seconds=max(r["rank_s"] for r in parts))


def sharded_train_template(small: bool):
    """The phase's train state as a template (shapes on ``"meta"``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib
    cfg = get_config("stablelm_1p6b")
    cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16") if small \
        else dataclasses.replace(cfg, n_layers=SHARDED_TRAIN_LAYERS)
    shapes = LM(cfg).param_shapes()
    moments = opt_lib.adamw().init(shapes)
    return {"params": shapes,
            "opt": opt_lib.OptState(0, moments.mu, moments.nu), "step": 0}


# ---------------------------------------------- sharded MoE and hybrid
#
# The MoE and hybrid families split over "model" (Queue A13), on the same
# spawn of 4 ranks, between the serve and the train phases
# (``sharded_moe_serve``, ``sharded_hybrid_serve`` and
# ``sharded_family_train`` lines, ``--only-sharded-family`` alone):
# DeepSeek-MoE-16B at its published widths in float32, 4 of 28 layers (the
# dense head block and 3 MoE blocks, 8.2 GB whole), on each mesh of
# ``SHARDED_SERVE_MESHES``; Zamba2-2.7B, 6 of 54 layers (one pattern: 5
# Mamba2 blocks and the shared attention block), each Mamba2 ``w_out`` at
# 1/32 of the init's scale as its LM path draws it, on (1, 4).  Each serves
# a prefill of SHARDED_FAMILY_BATCH exact-length prompts of
# SHARDED_FAMILY_PROMPT tokens (a multiple of the Mamba2 chunk, 64; a MoE's
# capacity depends on the length), then SHARDED_FAMILY_GEN greedy decode
# steps, held to this process's one-process serving of the same weights
# and masks.  Then one float32 SGD step of each at SHARDED_F32_LR on (2, 2)
# (ZeRO-3 over "data"), DeepSeek at 2 layers (the head block and one MoE
# block), against one process's step, which every rank takes itself, under
# sharded_train's float32 gates.
SHARDED_FAMILY_LAYERS = {"moe": 4, "hybrid": 6}
SHARDED_FAMILY_TRAIN_LAYERS = {"moe": 2, "hybrid": 6}
SHARDED_FAMILY_BATCH, SHARDED_FAMILY_PROMPT = 4, 64
SHARDED_FAMILY_GEN = 4
SHARDED_FAMILY_MESHES = {"moe": SHARDED_SERVE_MESHES, "hybrid": ((1, 4),)}
SHARDED_FAMILY_TRAIN_MESH = (2, 2)
SHARDED_FAMILY_TRAIN_SEQ = 64     # a global batch of SHARDED_FAMILY_BATCH


def sharded_family_cfg(kind: str, small: bool, train: bool = False):
    from repro_torch.configs import get_config
    spec = FAMILY_PATHS[0] if kind == "moe" else FAMILY_PATHS[1]
    cfg = get_config(spec.arch)
    if small:
        return spec, cfg.reduced()
    layers = (SHARDED_FAMILY_TRAIN_LAYERS if train
              else SHARDED_FAMILY_LAYERS)[kind]
    return spec, dataclasses.replace(cfg, n_layers=layers, dtype="float32")


def sharded_family_masks(model, device):
    """The served and trained masks: a quarter of every site's
    nonlinearities kept (``SERVE_FRACS``' budget), the same draw in every
    process."""
    from repro_torch.launch import serve_loop
    store = serve_loop.threshold_mask_sets(model, SERVE_FRACS[-1:],
                                           seed=SEED, device=device)
    return store.select(store.names[0])


def _markov_batch(vocab, batch, seq):
    from repro_torch.data import MarkovTokens
    return MarkovTokens(vocab, seed=SEED).batch(batch, seq, 0)


class route_spy:
    """Within the block, every MoE layer's routes (the experts of each
    token, ``(rows, S, k)``, from ``moe._top_k``) appended to ``calls[-1]``
    (:meth:`forward` starts a forward's list)."""

    def __init__(self):
        self.calls = []

    def forward(self):
        self.calls.append([])

    def __enter__(self):
        from repro_torch.models import moe
        self.orig = moe._top_k

        def spy(logits, c):
            gates, eidx = self.orig(logits, c)
            self.calls[-1].append(eidx.to(torch.int32).cpu().numpy())
            return gates, eidx
        moe._top_k = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._top_k = self.orig


def sharded_family_drive(tpm, params, masks, prefill, decode, device):
    """A prefill of the prompt and SHARDED_FAMILY_GEN greedy decode steps:
    tokens ``(B, 1 + gen)``, whole logits ``(1 + gen, B, V)``, each
    forward's routes and, for each decode tick (synchronised around it),
    its milliseconds and ``all_reduce`` calls."""
    from repro_torch.core import spmd
    from repro_torch.training import serve as serve_lib
    B, P = SHARDED_FAMILY_BATCH, SHARDED_FAMILY_PROMPT
    prompt = torch.from_numpy(_markov_batch(tpm.cfg.vocab, B, P)[
        "tokens"]).long().to(device)
    ticks = []
    with torch.no_grad(), route_spy() as spy:
        cache = tpm.init_cache(B, P + SHARDED_FAMILY_GEN + 1, device)
        sync(device)
        t0 = time.perf_counter()
        spy.forward()
        last, cache = prefill(params, masks, prompt, cache)
        sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = serve_lib.greedy_tokens(last, tpm, B)
        toks = [tok]
        logits = [serve_lib.gather_logits(last, tpm, B).float().cpu()]
        for t in range(SHARDED_FAMILY_GEN):
            spy.forward()
            before = spmd.collective_counts()["calls"]
            sync(device)
            t0 = time.perf_counter()
            tok, cache, last = decode(params, masks, tok, cache,
                                      np.full((B,), P + t, np.int64))
            sync(device)
            ticks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              calls=spmd.collective_counts()["calls"] -
                              before))
            toks.append(tok)
            logits.append(serve_lib.gather_logits(last, tpm, B)
                          .float().cpu())
    return dict(tokens=torch.cat(toks, 1).cpu().numpy(),
                logits=torch.stack(logits).numpy(), routes=spy.calls,
                prefill_ms=prefill_ms, ticks=ticks)


def sharded_family_one_process(root, device="cuda", small=False):
    """This process's side of the sharded MoE and hybrid serving: each
    model's one-process prefill and decode steps (tokens, logits and
    routes) saved under ``root`` for the ranks."""
    from repro_torch.training import serve as serve_lib
    for kind in ("moe", "hybrid"):
        spec, cfg = sharded_family_cfg(kind, small)
        model, params = make_lm(SEED, spec, device, cfg=cfg)
        masks = sharded_family_masks(model, device)
        got = sharded_family_drive(
            model, params, masks, serve_lib.make_prefill(model),
            serve_lib.make_decode_step(model), device)
        routes = {f"{i}_{j}": r for i, f in enumerate(got["routes"])
                  for j, r in enumerate(f)}
        np.savez(os.path.join(root, f"{kind}_one.npz"),
                 tokens=got["tokens"], logits=got["logits"], **routes)
        del model, params, masks, got
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def _routes_digest(calls) -> str:
    import hashlib
    h = hashlib.sha256()
    for f in calls:
        for r in f:
            h.update(np.ascontiguousarray(r).tobytes())
    return h.hexdigest()


def sharded_family_serve_case(kind, shape, root, device, small):
    """One family's model on one mesh, on this rank: the prefill and decode
    steps with counts set to 0 just before and read just after, held to
    the one-process run: tokens, logits up to the first forward whose
    routes differ, the routes of the rank's rows."""
    from repro_torch.core import spmd
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import serve as serve_lib
    spec, cfg = sharded_family_cfg(kind, small)
    B, P = SHARDED_FAMILY_BATCH, SHARDED_FAMILY_PROMPT
    t_case = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(*shape, device=device)
    model, full = make_lm(SEED, spec, device, cfg=cfg)
    params = serve_lib.shard_params(full, model, mesh)
    del full
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    masks = sharded_family_masks(model, device)
    scfg = serve_lib.ServeCfg(max_len=P + SHARDED_FAMILY_GEN + 1, batch=B)
    tpm = model.on_mesh(mesh)
    prefill = serve_lib.jit_prefill(model, mesh, scfg)
    decode = serve_lib.jit_decode_step(model, mesh, scfg)
    build.reset_launch_counts()
    spmd.reset_collective_counts()
    got = sharded_family_drive(tpm, params, masks, prefill, decode, device)
    launches = counts()
    drive_calls = spmd.collective_counts()["calls"]
    one = np.load(os.path.join(root, f"{kind}_one.npz"))
    rows = serve_lib.local_rows(np.arange(B), tpm, B)
    n_fwd = 1 + SHARDED_FAMILY_GEN
    # routes of this rank's rows against the one process's, forward by
    # forward: (token, k) entries that differ, and the first forward
    # where any does
    differ = [sum(int((r != one[f"{i}_{j}"][rows]).sum())
                  for j, r in enumerate(got["routes"][i]))
              for i in range(n_fwd)] if kind == "moe" else [0] * n_fwd
    first = next((i for i, n in enumerate(differ) if n), None)
    held = n_fwd if first is None else first
    err = [float(np.abs(got["logits"][i] - one["logits"][i]).max())
           for i in range(n_fwd)]
    ms = [t["ms"] for t in got["ticks"]]
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else None
    del params, model, tpm
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(
        kind=kind, mesh=list(shape), model=cfg.name, layers=cfg.n_layers,
        batch=B, prompt=P, decode_steps=SHARDED_FAMILY_GEN,
        rows=[int(r) for r in rows],
        tokens_equal_one_process=bool(np.array_equal(got["tokens"],
                                                     one["tokens"])),
        logits_vs_one_process=dict(
            max_abs_diff_by_forward=err, held_forwards=held,
            max_abs_diff_held=max(err[:held], default=0.0),
            tol=LM_LOGIT_TOL),
        routes=dict(differing_entries_by_forward=differ,
                    first_differing_forward=first,
                    sha256=_routes_digest(got["routes"]))
        if kind == "moe" else None,
        prefill_ms=got["prefill_ms"],
        decode_tick=dict(ms=ms, ms_median=float(np.median(ms)),
                         all_reduce_per_tick=sorted(
                             {t["calls"] for t in got["ticks"]})),
        all_reduce_calls_in_drive=drive_calls,
        launches={k: v for k, v in launches.items() if v},
        peak_bytes=peak, seconds=time.perf_counter() - t_case)


def sharded_family_step(kind, rank, device, small):
    """One float32 SGD step of ``kind`` at SHARDED_F32_LR on
    SHARDED_FAMILY_TRAIN_MESH, counts set to 0 just before and read just
    after, held to one process's step from the same state: every rank
    takes that step itself and keeps its own shard of the parameters
    before and after it, so the leaves are compared shard by shard and
    only each leaf's largest differences cross the ranks."""
    from repro_torch.core import spmd
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    spec, cfg = sharded_family_cfg(kind, small, train=True)
    t_case = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(*SHARDED_FAMILY_TRAIN_MESH, device=device)
    model = LM(cfg)
    sgd = opt_lib.sgd(lr=SHARDED_F32_LR, momentum=0.9, grad_clip=1.0)
    tcfg = train.TrainStepCfg(remat=True)
    held = train.held_state_specs(model, sgd, *SHARDED_FAMILY_TRAIN_MESH)
    masks = sharded_family_masks(model, device)
    t = _markov_batch(cfg.vocab, SHARDED_FAMILY_BATCH,
                      SHARDED_FAMILY_TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).to(device) for k, v in t.items()}

    def fresh():
        gen = torch.Generator(device=device).manual_seed(SEED)
        state = train.make_state(model, sgd, gen, device)
        if spec.w_o_scale != 1.0:
            for w in output_projections(state["params"]):
                w.mul_(spec.w_o_scale)
        return state

    def mine(params):
        return opt_lib.tree_leaves(
            mesh_lib.shard_tree(params, held["params"], mesh))
    start = fresh()
    p0 = mine(start["params"])
    one, m1 = train.make_train_step(model, sgd, tcfg)(start, batch, masks)
    p1 = mine(one["params"])
    names = opt_lib.tree_leaves(_leaf_names(one["params"]))
    del start, one
    state = train.shard_state(fresh(), model, sgd, mesh)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step = train.jit_train_step(model, sgd, mesh, tcfg)
    build.reset_launch_counts()
    spmd.reset_collective_counts()
    sync(device)
    t0 = time.perf_counter()
    state, met = step(state, batch, masks)
    sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    calls = spmd.collective_counts()["calls"]
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else None
    # per leaf: the largest |sharded - one process|, the largest update of
    # one process, the largest difference of the two updates
    local = torch.tensor([
        [float((a - b).abs().max()), float((b - z).abs().max()),
         float(((a - z) - (b - z)).abs().max())]
        for a, b, z in zip(opt_lib.tree_leaves(state["params"]), p1, p0)],
        dtype=torch.float32, device=device)
    for ax in (model.on_mesh(mesh).data_axis,
               model.on_mesh(mesh).model_axis):
        local = spmd.all_reduce_max(local, ax)
    errs, moved, diff = (c.tolist() for c in local.cpu().unbind(1))
    rel = [d / max(m, 1e-30) for d, m in zip(diff, moved)]
    del state, p0, p1
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(
        model=cfg.name, layers=cfg.n_layers,
        mesh=list(SHARDED_FAMILY_TRAIN_MESH), optimizer="sgd",
        lr=SHARDED_F32_LR, batch=SHARDED_FAMILY_BATCH,
        seq=SHARDED_FAMILY_TRAIN_SEQ, step_ms=step_ms,
        all_reduce_calls=calls, peak_bytes=peak,
        launches={k: v for k, v in launches.items() if v},
        loss_sharded=float(met["loss"]), loss_one_process=float(m1["loss"]),
        grad_norm_sharded=float(met["grad_norm"]),
        grad_norm_one_process=float(m1["grad_norm"]),
        max_abs_leaf_diff=max(errs), tol=SHARDED_F32_TOL,
        max_abs_update=max(moved), least_leaf_max_update=min(moved),
        least_moved_leaf=names[int(np.argmin(moved))],
        max_update_rel_diff=max(rel), update_rel_tol=SHARDED_F32_UPDATE_REL,
        worst_update_leaf=names[int(np.argmax(rel))],
        seconds=time.perf_counter() - t_case)


def run_sharded_family_rank(rank, world, root, device="cuda", small=False):
    """One rank of the sharded MoE and hybrid phase: DeepSeek-MoE-16B on
    each mesh of ``SHARDED_FAMILY_MESHES["moe"]``, Zamba2-2.7B on (1, 4),
    then the float32 step of each."""
    out = dict(rank=rank, serve=[], train=[])
    for kind in ("moe", "hybrid"):
        for shape in SHARDED_FAMILY_MESHES[kind]:
            out["serve"].append(sharded_family_serve_case(
                kind, shape, root, device, small))
    for kind in ("moe", "hybrid"):
        out["train"].append(sharded_family_step(kind, rank, device, small))
    return out


def judge_sharded_family(parts, by_path, device):
    """Gates of the sharded MoE and hybrid lines: on every rank and mesh
    the one process's tokens, logits within LM_LOGIT_TOL up to the first
    forward whose routes differ (a MoE; every forward of the hybrid), the
    model ranks of a batch slice routing alike (equal route digests), the
    path's kernels launched; the float32 steps under sharded_train's
    gates.  Returns the three lines."""
    lines = {}
    cuda = torch.device(device).type == "cuda"
    for kind, path in (("moe", "sharded_moe_serve"),
                       ("hybrid", "sharded_hybrid_serve")):
        cases = []
        for res in parts:
            for case in res["serve"]:
                if case["kind"] != kind:
                    continue
                where = f"{path} {case['mesh']} rank {res['rank']}"
                lg = case["logits_vs_one_process"]
                if not case["tokens_equal_one_process"]:
                    fail(f"{where}: tokens differ from one process's")
                if not lg["max_abs_diff_held"] <= LM_LOGIT_TOL:
                    fail(f"{where}: logits vs one process: {lg}")
                if kind == "hybrid" and lg["held_forwards"] != \
                        1 + SHARDED_FAMILY_GEN:
                    fail(f"{where}: not every forward held: {lg}")
                missing = [k for k in PATH_KERNELS[path]
                           if case["launches"].get(k, 0) == 0]
                if missing and cuda:
                    fail(f"{where}: no launch of {missing}")
                cases.append(dict(rank=res["rank"], **case))
        if kind == "moe":
            for shape in SHARDED_FAMILY_MESHES[kind]:
                mine = [c for c in cases if c["mesh"] == list(shape)]
                by_rows = {}
                for c in mine:
                    by_rows.setdefault(tuple(c["rows"]), set()).add(
                        c["routes"]["sha256"])
                if len(by_rows) != shape[0] or any(
                        len(v) != 1 for v in by_rows.values()):
                    fail(f"{path} {list(shape)}: the model ranks of a batch "
                         f"slice route apart: {by_rows}")
        sum_launches(cases, by_path, path)
        lines[path] = dict(world=SHARDED_WORLD, backend="gloo",
                           note="4 ranks share one card: correctness runs, "
                                "not a speed-up",
                           cases=cases)
    steps = []
    for res in parts:
        for st in res["train"]:
            where = f"sharded_family_train {st['model']} rank {res['rank']}"
            if not _f32_step_ok(st):
                fail(f"{where}: float32 step vs one process: {st}")
            missing = [k for k in PATH_KERNELS["sharded_family_train"]
                       if st["launches"].get(k, 0) == 0]
            if missing and cuda:
                fail(f"{where}: no launch of {missing}")
            steps.append(dict(rank=res["rank"], **st))
    sum_launches(steps, by_path, "sharded_family_train")
    lines["sharded_family_train"] = dict(
        world=SHARDED_WORLD, backend="gloo",
        note="4 ranks share one card: correctness runs, not a speed-up",
        steps=steps)
    seconds = max(r["rank_s"] for r in parts)
    for line in lines.values():
        line["phase_seconds"] = seconds
    return lines


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
    """The tree with each leaf replaced by its dotted path (a str leaf); a
    list's items by index, so an empty list holds no leaf, as in
    ``optimizer.tree_leaves``."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaf_names(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
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
        elif any(t in low for t in ("gemm", "sgemm", "cutlass", "cublas",
                                     "nvjet", "xmma")):
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
    t_phase = time.perf_counter()
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
    seconds = {"train": time.perf_counter() - t_phase}
    t_phase = time.perf_counter()

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
        test_acc_at_b_ref=float(test_acc_fn(ft[0], res.masks)),
        seconds=time.perf_counter() - t_phase)
    t_phase = time.perf_counter()

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
                        loss_last=losses[-1]),
        seconds=seconds["train"])
    pipeline_line = dict(
        stages={"train_base": stages["train_base"], "snl": stages["snl"],
                "finetune": stages["finetune"],
                "bcd": {r["engine"]: r["wall_s"] for r in runs}},
        bcd=dict(b_ref=b_ref, b_target=b_ref - drc * TRAIN_BCD_STEPS,
                 drc=drc, rt=rt, adt=-100.0, chunk_size=chunk,
                 finetune_steps=FT_STEPS, runs=runs),
        engines_identical=True, seconds=time.perf_counter() - t_phase)
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
    bf16_bcd: bool = False   # BCD at the config's bfloat16 as well
    layers: int = 0     # n_layers of the path's model (0: every layer)


LM_PATHS = (
    # StableLM also runs BCD at its own bfloat16 (``lm_bf16_bcd``): the
    # suffix engine's fused forwards on route A (kernels 3/4, wgmma).  12 of
    # its 24 layers, sited at the same shares of the depth as at 24 (@8,
    # @20): the script's time (the path took 47 s at 24 on one H100; the
    # float32 ``serve`` line and ``sharded_serve`` keep all 24)
    LMPath("stablelm_1p6b", "lm", 128, 1, True, ("s0.ffn@4", "s0.ffn@10"),
           0, bf16_bcd=True, layers=12),
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
    LMPath("rwkv6_3b", "rwkv", 129, 32, False, ("s0.rwkv@2", "s0.rwkv@6"),
           8, w_o_scale=1 / 32, layers=8),
)
# The MoE and hybrid paths, each also served (``<tag>_serve`` line).
# RWKV-6 above and Zamba2 below run a quarter and a third of their
# published depth (``layers``: the depth of RWKV-6's card-vs-CPU check,
# and 3 of Zamba2's 9 repeats), to pay in the script's time for serving
# and sweeping the families in their bfloat16; the bfloat16 serving runs
# each family at its path's depth too.  DeepSeek runs 14 of its 28 layers,
# sited at ``s0.moe@4`` and ``s0.moe@10``: every engine runs one gate route
# per run, so the suffix engine's fused forwards read every trial as the
# batched engine's fused forwards do (ROADMAP Queue C 7).
# DeepSeek-MoE-16B: a dense head block and 27 MoE blocks, 16.2 B parameters,
# 64.7 GB in float32 at all 28 layers (32 GB at the path's 14), no
# bfloat16 forward on this path (the serve phase runs it in bfloat16 at
# the path's depth); exact-length greedy forwards (pad 1: a MoE's capacity
# depends on the length); the card-vs-CPU check runs the head block and
# the first MoE repeat (3.5 GB on the host); 1.26 M nonlinearities at 14
# layers, and a BCD step removes 4096, as at 28.
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
    LMPath("deepseek_moe_16b", "moe", 128, 1, True, ("s0.moe@4", "s0.moe@10"),
           1, bf16=False, drc=4096, layers=14),
    LMPath("zamba2_2p7b", "hybrid", 129, 64, False,
           ("s0.mamba@1", "s4.mamba@2"), 2, w_o_scale=1 / 32, drc=512,
           layers=18),
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
    from repro_torch.configs import get_config
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
    if spec.layers:
        out["layers"] = f"{spec.layers} of the config's " \
            f"{get_config(spec.arch).n_layers}: the script's time"
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


class pinned_routes:
    """Within the block, every MoE routing of a forward takes the experts
    given, layer by layer in call order, at its first positions (its own
    beyond them), with gates computed from its own router logits as
    ``models.moe._top_k`` computes them (softmax, the chosen experts'
    probabilities, renormalised): chip_smoke.py holds a forward to the
    routes a served run chose.  Each routing's router logits and the
    experts its own top-k would have taken are kept (``logits``, ``own``)
    for :func:`route_gate`.  Measurement only; the function is put back
    on exit."""

    def __init__(self, routes):
        self.routes, self.calls = routes, 0
        self.logits, self.own = [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe._top_k

        def pinned(logits, c):
            _, own = self.inner(logits, c)
            want = self.routes[self.calls % len(self.routes)]
            self.calls += 1
            n = want.shape[-2]
            self.logits.append(logits[..., :n, :].float())
            self.own.append(own[..., :n, :])
            eidx = torch.cat([want.to(own.device), own[..., n:, :]], dim=-2)
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            gates = torch.gather(probs, -1, eidx)
            return gates / gates.sum(-1, keepdim=True), eidx
        moe._top_k = pinned
        return self

    def __exit__(self, *exc):
        self.moe._top_k = self.inner


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


ENGINES = ("sequential", "batched", "pipelined", "suffix")


def run_lm_bcd(model, params, batch, steps: int, drc: int, spec,
               device="cuda", backends=ENGINES, tag=None, cost_model=None,
               other_route: bool = True):
    """``bcd.run_bcd`` on the LM through ``backends`` (the four engines)
    on the path's gate route (fused where the config has the fused route),
    and, where it has and ``other_route``, the batched and suffix engines
    on the unfused route as well: under each route identical selections,
    and at least one step whose trials did not all tie.  Where the engines
    part, every trial's accuracy of each engine but the sequential one
    goes into the ``<tag>_failed`` line.  ``cost_model`` replaces the
    suffix engine's (``SuffixCostModel``), which decides which chunks take
    the suffix path."""
    from repro_torch.core import bcd, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    tag = tag or f"{spec.tag}_bcd"
    masks0 = linearize.init_masks(model.mask_sites())
    total = model.relu_count()
    rt = 16
    runs_by_route, prints, trial_accs = {}, {}, {}
    plan = [(b, spec.fused) for b in backends]
    if spec.fused and other_route:
        plan += [(b, False) for b in ("batched", "suffix")]
    for backend, fused in plan:
        route = "fused" if fused else "unfused"
        holder = {"params": params}
        evaluator, eval_acc, _ = make_bcd_evaluator(
            backend, model, batch, holder, chunk_size=LM_CHUNK, rt=rt,
            prefetch=2, fused_kernels=fused, device=device)
        if backend == "suffix" and cost_model is not None:
            evaluator.cost_model = cost_model
        key = (route, backend)
        if backend != "sequential":
            # record every trial accuracy (rt per step, in order)
            inner = evaluator.evaluate_staged
            trial_accs[key] = []

            def recording(staged, inner=inner, out=trial_accs[key]):
                accs = inner(staged)
                out.extend(float(a) for a in accs)
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
            fail(f"{tag} {backend}: budget {M.relu_cost(res.masks)}")
        accs = [h.acc_before for h in res.history]
        if not all(np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs):
            fail(f"{tag} {backend}: accuracies {accs}")
        trials = sum(h.trials for h in res.history)
        prints[key] = M.fingerprint(res.masks)
        run = dict(backend=backend, route=route, steps=len(res.history),
                   trials=trials, wall_s=wall,
                   candidates_per_s=(trials + len(res.history)) / wall,
                   fingerprint=prints[key][:16],
                   best_drops=[h.best_drop for h in res.history],
                   acc_before=accs,
                   launches={k: v for k, v in launches.items() if v})
        trie = getattr(evaluator, "trie", None)
        if trie is not None:
            run["trie"] = dict(hits=trie.hits, extensions=trie.extensions,
                               misses=trie.misses)
        runs_by_route.setdefault(route, []).append(run)
    for route in runs_by_route:
        mine = {k: v for k, v in prints.items() if k[0] == route}
        if len(set(mine.values())) != 1:
            emit({f"{tag}_failed": dict(
                runs=runs_by_route[route],
                trial_accs={b: v for (r, b), v in trial_accs.items()
                            if r == route})})
            fail(f"{tag}: engines selected different blocks on the {route} "
                 f"route: {mine}")
    main_route = "fused" if spec.fused else "unfused"
    step_accs = trial_accs[(main_route, "batched")]
    distinct = [len(set(step_accs[i:i + rt]))
                for i in range(0, len(step_accs), rt)]
    if not distinct or max(distinct) < 2:
        fail(f"{tag}: every step's trials tied ({distinct} distinct "
             "accuracies per step): the parity would be vacuous")
    between = None
    if len(runs_by_route) == 2:
        a = trial_accs[("fused", "batched")]
        b = trial_accs[("unfused", "batched")]
        between = dict(
            selections_part=prints[("fused", "batched")] !=
            prints[("unfused", "batched")],
            first_step_trials_apart=[i for i in range(rt) if a[i] != b[i]])
    return dict(model=model.cfg.name,
                dtype=str(model.dtype).replace("torch.", ""), batch=LM_BATCH,
                tokens=spec.seq - 1, drc=drc, rt=rt, chunk_size=LM_CHUNK,
                adt=-100.0, moves=["remove"], steps=steps,
                distinct_trial_accs_per_step=distinct,
                runs=runs_by_route[main_route],
                runs_other_route=runs_by_route.get("unfused")
                if spec.fused else None,
                routes=between)


def run_lm_bf16_bcd(spec, steps: int, device="cuda"):
    """BCD at the config's own bfloat16: the model drawn from the path's
    seed in bfloat16, an eval batch of its own greedy continuations
    (:func:`make_lm_batch`), and ``run_bcd`` through the batched engine and
    the suffix engine, both on the fused route (kernels 3/4 on route A,
    ``wgmma``): identical selections, and route A's stacked kernel
    launched.  A block of ``spec.drc`` = 256 random coordinates of 24 x
    5632 touches the first repeat's FFN all but always ((23/24)^256 = 2e-5
    misses it), and the default cost model sends a chunk cut there
    (prefix fraction 0) down the full forward; so the suffix engine runs
    with a cost model that takes every chunk of two or more candidates on
    the suffix path: the embedding is the prefix."""
    t0 = time.perf_counter()
    model, params = make_lm(SEED, spec, device, dtype="bfloat16")
    batch, info = make_lm_batch(model, params, SEED, spec, device)
    info["seconds"] = time.perf_counter() - t0
    before = counts()
    t0 = time.perf_counter()
    from repro_torch.analysis.roofline import SuffixCostModel
    out = run_lm_bcd(model, params, batch, steps, spec.drc, spec, device,
                     backends=("batched", "suffix"),
                     tag=f"{spec.tag}_bf16_bcd",
                     cost_model=SuffixCostModel(min_prefix_fraction=0.0),
                     other_route=False)
    out["suffix_cost_model"] = "SuffixCostModel(min_prefix_fraction=0.0)"
    out["seconds"] = time.perf_counter() - t0
    out["batch_info"] = info
    out["launches"] = {k: v - before[k] for k, v in counts().items()
                       if v - before[k]}
    del model, params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        if out["launches"].get("masked_act_matmul_2d_batched:wgmma", 0) == 0:
            fail(f"{spec.tag}_bf16_bcd: route A's stacked kernel "
                 "(masked_act_matmul_2d_batched, wgmma) was not launched")
    return out


def route_engines(fused_route: bool, backends=("batched", "suffix")):
    """(label, backend, fused) for each engine under each gate route: the
    unfused route, and the fused one where the path has it."""
    routes = (False, True) if fused_route else (False,)
    return [(f"{b}_{'fused' if f else 'unfused'}", b, f)
            for f in routes for b in backends]


def routes_apart(accs: dict) -> dict:
    """Between the two routes, per engine: the trials read apart to the
    bit and the largest difference (reported, not gated)."""
    out = {}
    for b in sorted({k.rsplit("_", 1)[0] for k in accs}):
        a, f = accs.get(f"{b}_unfused"), accs.get(f"{b}_fused")
        if a is None or f is None:
            continue
        out[b] = dict(trials_apart=[int(i) for i in np.flatnonzero(a != f)],
                      max_abs_diff=float(np.abs(a - f).max()))
    return out


def run_lm_sited(model, params, batch, drc: int, spec, device="cuda",
                 reps: int = LM_SITED_REPS):
    """Site-local candidates at mid-scan per-repeat sites through the
    batched engine and the suffix engine under the unfused gate route and,
    where the config has it, the fused one: under each route the suffix
    engine's accuracies equal to the bit to the batched engine's, prefix
    reuse in the trie, and the rates over ``reps`` timed passes; between
    the routes, the trials read apart (reported)."""
    from repro_torch.core import engine as E, linearize, masks as M
    from repro_torch.launch.sweep import make_bcd_evaluator
    masks0 = linearize.init_masks(model.mask_sites())
    fractions = model.site_prefix_fractions()
    rng = np.random.default_rng(0)
    n_cand, out = 16, []
    engines = route_engines(spec.fused)
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
                fail(f"{spec.tag}_sited {site} {label}: the fused route did "
                     "not launch masked_act_matmul_2d_batched")
        for route in {lab.rsplit("_", 1)[1] for lab, _, _ in engines}:
            got, want = accs[f"suffix_{route}"], accs[f"batched_{route}"]
            if not np.array_equal(got, want):
                emit({f"{spec.tag}_sited_failed": sited_diagnosis(
                    model, params, batch, masks0, chunks, site, got, want,
                    route == "fused", device)})
                fail(f"{spec.tag}_sited {site}: suffix_{route} accuracies "
                     f"{got} differ from batched_{route} {want}")
        row["accs"] = {lab: [float(a) for a in v] for lab, v in accs.items()}
        row["routes_apart"] = routes_apart(accs)
        row["suffix_vs_batched"] = {
            lab.split("_", 1)[1]: row[lab]["candidates_per_s"] /
            row["batched_" + lab.split("_", 1)[1]]["candidates_per_s"]
            for lab, backend, _ in engines if backend == "suffix"}
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
        with record_routes() as rec:
            gen = serve.generate(m, params, masks, prompts, n_gen,
                                 ties=False, keep_logits=True)
        gen["routes"] = rec.calls
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
    dec = gen["decode_ms"]
    out = dict(model=cfg.name, dtype="float32", batch=FAMILY_SERVE_BATCH,
               prompt=P, gen=n_gen, prefill_ms=gen["prefill_ms"],
               decode_ms_mean=float(np.mean(dec)),
               decode_ms_min=float(np.min(dec)), decode_steps=len(dec),
               **decode_bound(model, params, gen["routes"], n_gen),
               margin=SERVE_MARGIN, check=check)
    if moe:
        out["check"]["capacity_factor"] = cfg.n_experts / cfg.top_k
        out["own_capacity"] = dict(capacity_factor=cfg.capacity_factor,
                                   **served(model)[1])
    return out


def sited_diagnosis(model, params, batch, masks0, chunks, site, got, want,
                    fused, device="cuda"):
    """Why a suffix evaluation disagreed with the batched one on one gate
    route (``fused``): for each chunk holding a disagreeing candidate, the
    largest logit difference between the suffix forward over the shared
    prefix and the full stacked forward, the labelled positions whose argmax differs and their top-2
    margins there, and the MoE routes that differ (both forwards with the
    engines' host decision, ``linearize.first_differences``)."""
    from repro_torch.core import linearize, masks as M
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
                full = model.forward(
                    params, st, x, ties=False, fused=fused,
                    differ=linearize.first_differences(chunks[c]))
            cached = model.forward_prefix(params, base, x, site,
                                          fused=fused, ties=False)
            names = model.suffix_sites(site)
            sub = {k: st[k] for k in names}
            with rb:
                suf = model.forward_suffix(
                    params, sub, cached, site, fused=fused, ties=False,
                    differ=linearize.first_differences(
                        {k: chunks[c][k] for k in names}))
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
    cfg = None
    if spec.layers:
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config(spec.arch),
                                  n_layers=spec.layers)
    model, params = make_lm(SEED, spec, device, cfg=cfg)
    sync(device)
    memory.update(param_bytes=param_bytes(params),
                  init_s=time.perf_counter() - t0)
    if cuda:
        memory["after_init_max_allocated"] = torch.cuda.max_memory_allocated()
    batch, batch_info = make_lm_batch(model, params, SEED, spec, device)
    batch_info["seconds"] = time.perf_counter() - t0
    emit({f"{spec.tag}_batch": batch_info})
    build.reset_launch_counts()
    t0 = time.perf_counter()
    forward = run_lm_forward(model, params, batch, SEED, spec, device)
    if family and cuda:
        forward["profile"] = profile_forwards(model, params, batch, SEED)
    forward["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    bcd_report = run_lm_bcd(model, params, batch, LM_STEPS, spec.drc, spec,
                            device)
    bcd_report["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    sited = run_lm_sited(model, params, batch, LM_SITED_DRC, spec, device)
    sited["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    bf16_bcd = run_lm_bf16_bcd(spec, LM_STEPS, device) if spec.bf16_bcd \
        else None
    t0 = time.perf_counter()
    served = run_family_serve(model, params, spec, device) if family \
        else None
    if served is not None:
        served["seconds"] = time.perf_counter() - t0
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
    if bf16_bcd is not None:
        emit({f"{spec.tag}_bf16_bcd": bf16_bcd})
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
    row = cfg.n_kv_heads * cfg.head_dim * model.dtype.itemsize * 2
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


def decode_bound(model, params, calls, steps: int) -> dict:
    """The byte bound of a decode step: every parameter read once (the
    embedding once), but of a MoE's routed experts only those its tokens
    were routed to in that step (``calls``: :class:`record_routes` of a
    prefill, then ``steps - 1`` decode steps), averaged over the decode
    steps."""
    total = param_bytes(params)
    L = len(calls) // steps if calls else 0
    if not L or steps < 2:
        return dict(decode_bound_ms=total / HBM_BYTES_PER_S * 1e3,
                    decode_bound_by="bytes (every parameter read once a "
                                    "step)")
    routed = []

    def walk(t):
        if isinstance(t, dict):
            if "router" in t:
                routed.extend(t[k] for k in ("w_gate", "w_up", "w_down"))
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(params)
    all_experts = sum(t.numel() * t.element_size() for t in routed)
    per_expert = all_experts / (L * model.cfg.n_experts)
    used = [sum(int(calls[s * L + i][0].unique().numel()) for i in range(L))
            for s in range(1, steps)]
    step_bytes = total - all_experts + float(np.mean(used)) * per_expert
    return dict(decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                decode_bound_by="bytes (every parameter read once a step, "
                                "of the routed experts those the step's "
                                "tokens were routed to)",
                routed_experts_a_step=float(np.mean(used)),
                of_routed_experts=L * model.cfg.n_experts)


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


def run_serve_stablelm(device="cuda", dtype="float32", layers=0):
    """StableLM-2-1.6B at full width, in ``dtype`` (float32, or the
    config's own bfloat16 from the same seed's draws rounded), on its
    first ``layers`` layers (0: all of them): a
    ``ServeLoop`` of two synthetic budgets, 4 slots of 128 tokens, prompts
    bucketed to 16, ``SERVE_REQUESTS`` requests of 4-100 tokens and 16 new
    tokens each, alternating between the classes; counts set to 0 just
    before the drive, read just after.  Then the served tokens against the
    uncached forward (:func:`served_consistency`, in bfloat16
    :func:`served_consistency_bf16`), the timings and the card's peak
    memory."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve_loop
    from repro_torch.configs import get_config
    resident = _reset_peak(device)
    cfg = get_config(LM_PATHS[0].arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))
    model, params = make_lm(SEED, LM_PATHS[0], device, cfg=cfg, dtype=dtype)
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
    consistency = served_consistency if dtype == "float32" else \
        served_consistency_bf16
    out = dict(model=model.cfg.name, layers=model.cfg.n_layers,
               dtype=dtype, slots=SERVE_SLOTS,
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
               check=consistency(model, params, store, reqs,
                                 LM_PATHS[0].pad, device))
    for r in reqs:
        r.logits = None
    if torch.device(device).type == "cuda":
        out.update(time_serve_ticks(model, params, store, loop, device))
        out["memory"] = _peak(device, resident)
        del model, params, store, loop, reqs
        gc.collect()
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


# ---------------------------------------- serving in the configs' bfloat16


def upcast_logits(model, params, masks, tokens):
    """Logits of the float32 forward of a bfloat16 model's parameters,
    upcast, on ``tokens`` (no cache): the yardstick of the bfloat16 serving
    gates.  ``LM.forward(upcast=True)`` casts one block's parameters at a
    time (DeepSeek-MoE-16B's 32.3 GB of bfloat16 parameters leave no room
    for a 64.7 GB float32 copy beside them); where a float32 copy fits it
    is the forward of the upcast parameters (the CPU rehearsal checks that
    to the bit)."""
    from repro_torch.models import lm
    m32 = lm.LM(dataclasses.replace(model.cfg, dtype="float32"))
    with torch.no_grad():
        return m32.forward(params, masks, tokens, ties=False, upcast=True)


def judge_bf16(kept, full, exact, tokens, where):
    """The bfloat16 serving gates over the positions of rows of (n, V)
    logits: ``kept`` (the cached path's), ``full`` (the uncached bfloat16
    forward's, teacher-forced on the served sequence) and ``exact`` (the
    float32 forward of the same parameters, upcast).

    * Every served token is the argmax of its kept logits.
    * Logits: the cached logits' largest error against ``exact`` at most
      ``SERVE_BF16_RATIO`` times the uncached forward's, plus
      ``SERVE_BF16_ABS``: the cache adds no error beyond what bfloat16
      itself costs.
    * Tokens: the served token ``s`` is the uncached argmax ``a`` at
      ``SERVE_BF16_TOKENS`` of all positions at least, where a position
      with ``s != a`` counts as agreeing when the uncached gap ``full[a] -
      full[s]`` is at most ``(1 + SERVE_BF16_RATIO) * (e[a] + e[s]) +
      SERVE_BF16_ABS``, ``e = |full - exact|`` there: the most the two
      paths may differ by at those two logits when the cached one's error
      is held as the logit gate holds it.  No position is left out.
    * The cached path's argmax agrees with the float32 forward's at no
      fewer positions than the uncached forward's does, less
      ``1 - SERVE_BF16_TOKENS``."""
    exact = exact.float()
    kept, full = kept.float(), full.float()
    tokens = tokens.to(full.device).long()
    n = int(tokens.numel())
    if not n:
        fail(f"{where}: no position to judge")
    cached = float((kept - exact).abs().max())
    uncached = float((full - exact).abs().max())
    rows = torch.arange(n, device=full.device)
    a = full.argmax(-1)
    err = (full - exact).abs()
    gap = full[rows, a] - full[rows, tokens]
    window = (1 + SERVE_BF16_RATIO) * (err[rows, a] + err[rows, tokens]) + \
        SERVE_BF16_ABS
    miss = tokens != a
    excused = miss & (gap <= window)
    out = dict(positions=n, misses=int(miss.sum()),
               misses_within_window=int(excused.sum()),
               max_misses_beyond=(1 - SERVE_BF16_TOKENS) * n,
               token_agreement=float((~miss).float().mean()),
               token_agreement_with_window=float(
                   (~miss | excused).float().mean()),
               # where the served token is not the uncached argmax: the
               # uncached gap there and its window
               miss_gaps=gap[miss].tolist(),
               miss_windows=window[miss].tolist(),
               served_is_kept_argmax=bool(
                   torch.equal(kept.argmax(-1), tokens)),
               logit_abs_max=float(full.abs().max()),
               cached_argmax_vs_f32=float(
                   (kept.argmax(-1) == exact.argmax(-1)).float().mean()),
               uncached_argmax_vs_f32=float(
                   (full.argmax(-1) == exact.argmax(-1)).float().mean()),
               cached_max_abs_err_vs_f32=cached,
               uncached_max_abs_err_vs_f32=uncached,
               cached_bound=SERVE_BF16_RATIO * uncached + SERVE_BF16_ABS,
               cached_vs_uncached_max_abs_diff=float(
                   (kept - full).abs().max()))
    if not out["served_is_kept_argmax"] or \
            out["misses"] - out["misses_within_window"] > \
            out["max_misses_beyond"] or not cached <= out["cached_bound"] \
            or out["cached_argmax_vs_f32"] < out["uncached_argmax_vs_f32"] \
            - (1 - SERVE_BF16_TOKENS):
        fail(f"{where}: bfloat16 serving gates: {out}")
    return out


def served_consistency_bf16(model, params, store, reqs, pad, device):
    """Every completed request of a bfloat16 ``keep_logits`` loop: its
    served tokens against the uncached bfloat16 forward of its prompt and
    the tokens generated before each position (teacher forcing, padded
    with zeros to a multiple of ``pad``, exact as in :func:`last_logits`),
    and the kept logits and the uncached ones against the float32 forward
    of the same parameters, upcast (:func:`judge_bf16`)."""
    kept, full, exact, toks = [], [], [], []
    with torch.no_grad():
        for r in reqs:
            seq = np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int64)
            n = len(seq)
            seq = np.concatenate([seq, np.zeros(-(-n // pad) * pad - n,
                                                np.int64)])
            x = torch.from_numpy(seq)[None].to(device)
            masks = store.select(r.mask_set)
            lo = len(r.prompt) - 1
            full.append(model.forward(params, masks, x,
                                      ties=False)[0, lo:n].float())
            exact.append(upcast_logits(model, params, masks, x)[0, lo:n])
            kept.append(torch.stack(r.logits).float())
            toks.append(torch.tensor(r.tokens))
            if kept[-1].shape != full[-1].shape or \
                    not bool(torch.isfinite(kept[-1]).all()):
                fail(f"serve bfloat16: request {r.rid} kept logits "
                     f"{tuple(kept[-1].shape)} vs {tuple(full[-1].shape)}, "
                     "or not finite")
    return judge_bf16(torch.cat(kept), torch.cat(full), torch.cat(exact),
                      torch.cat(toks), "serve bfloat16")


def route_diff(cached_calls, uncached_calls, steps: int, n: int):
    """The (token, k) routes of a cached run (a prefill, then ``steps - 1``
    decode steps, :class:`record_routes` calls in order) against those of
    the uncached forward of the same ``n`` tokens, layer by layer: the
    counts (by layer, and of (token, layer) pairs whose set of experts
    differs, not only their order), each row's first position whose route
    differs in some layer (``n`` where none does), and the cached run's
    routes, (B, n, k) a layer."""
    L = len(uncached_calls)
    if len(cached_calls) != L * steps:
        fail(f"route_diff: {len(cached_calls)} cached routings, expected "
             f"{L} layers x {steps} forwards")
    compared, first, by_layer, sets, cached = 0, None, [], 0, []
    for layer in range(L):
        a = torch.cat([cached_calls[s * L + layer][0] for s in range(steps)],
                      dim=-2)
        b = uncached_calls[layer][0][..., :n, :]
        cached.append(a)
        ne = a != b
        by_layer.append(int(ne.sum()))
        sets += int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
        compared += ne.numel()
        pos = ne.any(-1)
        first = pos if first is None else first | pos
    idx = torch.arange(n, device=first.device)
    first_pos = torch.where(first, idx, n).amin(-1)
    return dict(moe_layers=L, routes_compared=compared,
                routes_differ=sum(by_layer), routes_differ_by_layer=by_layer,
                token_layers_whose_expert_set_differs=sets,
                first_differing_position=first_pos.tolist()), cached


def route_gate(served, bf, f32, where):
    """The MoE routes a bfloat16 run served (``served``: (B, n, k) experts
    a layer) against its yardstick, the uncached bfloat16 forward pinned
    to them (``bf``, a :class:`pinned_routes` that ran), layer by layer:
    wherever the yardstick's own router would have taken another set of
    experts for a token, each served expert it would not have taken must
    trail the k-th of its own choices, in router logits, by at most
    ``2 (1 + SERVE_BF16_RATIO)`` times the layer's largest router-logit
    error of that forward against the float32 forward pinned alike
    (``f32``): a choice that two bfloat16 evaluations of the layer, each
    held as the logit gate holds it, can make apart, and no wrong
    expert."""
    L = len(served)
    if len(bf.logits) != L or len(f32.logits) != L:
        fail(f"{where}: {len(bf.logits)} and {len(f32.logits)} pinned "
             f"routings for {L} MoE layers")
    layers, worst = [], 0.0
    for lb, lf, own, want in zip(bf.logits, f32.logits, bf.own, served):
        delta = float((lb - lf).abs().max())
        window = 2 * (1 + SERVE_BF16_RATIO) * delta
        want = want.to(own.device)
        in_own = (want[..., :, None] == own[..., None, :]).any(-1)
        kth = lb.gather(-1, own).amin(-1, keepdim=True)
        deficit = torch.where(in_own, torch.zeros_like(kth),
                              kth - lb.gather(-1, want))
        most = float(deficit.max())
        layers.append(dict(experts_not_own=int((~in_own).sum()),
                           max_deficit=most, router_err_vs_f32=delta,
                           window=window))
        if most > window:
            fail(f"{where}: a served expert trails its yardstick's own "
                 f"top-k by {most} router logits, beyond {window}: "
                 f"{layers}")
        if window > 0:
            worst = max(worst, most / window)
    return dict(moe_layers=L, rule="each served expert the yardstick's "
                "own top-k would not take trails its k-th choice by <= "
                f"2 * (1 + {SERVE_BF16_RATIO}) * the layer's router-logit "
                "error, bfloat16 vs float32",
                experts_not_own=sum(x["experts_not_own"] for x in layers),
                worst_deficit_over_window=worst, by_layer=layers)


def time_decode_steps(model, params, masks, prompts, device):
    """After ``generate``: a cache prefilled with the prompts, then decode
    steps of the whole batch at one position (the work of a step does not
    depend on the cache's contents): the host clock around each
    synchronised step, our kernels' launches a step and one profiler
    window."""
    from repro_torch.kernels import build
    from repro_torch.training import serve as serve_lib
    B, P = prompts.shape
    step = serve_lib.make_decode_step(model)
    with torch.no_grad():
        cache = model.init_cache(B, P + 1, device)
        last, cache = serve_lib.make_prefill(model)(params, masks, prompts,
                                                    cache, ties=False)
        tok = last.argmax(-1)[:, None].to(torch.int32)

        def tick(_=0):
            return step(params, masks, tok, cache, P, ties=False)
        tick()
        sync(device)
        before, walls = dict(build.launch_counts), []
        for _ in range(SERVE_TIMED_TICKS):
            t0 = time.perf_counter()
            tick()
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: (build.launch_counts[k] - before[k]) /
                    SERVE_TIMED_TICKS for k in before
                    if build.launch_counts[k] != before[k]}
        prof = profile_window(tick, 5)
    return dict(ms_mean=float(np.mean(walls)), ms_min=float(np.min(walls)),
                steps=len(walls), our_kernel_launches=per_step, profile=prof)


def run_serve_generate_bf16(spec, batch: int, prompt: int, n_gen: int,
                            device="cuda"):
    """One model at its published widths and its LM path's depth
    (``spec.layers``) in its own bfloat16 (the path's seed's draws
    rounded, as ``lm_bf16_bcd``): ``launch.serve.generate``
    of ``batch`` Markov prompts of ``prompt`` tokens by ``n_gen`` tokens
    (density-0.9 masks), the served tokens and the kept logits judged by
    :func:`judge_bf16` against the uncached bfloat16 forward of the served
    sequence (teacher forcing) and the float32 forward of the same
    parameters, upcast (:func:`upcast_logits`).  The MoE runs at
    ``capacity_factor = E / top_k`` (no pair dropped at any length, the
    decode step unchanged, as :func:`run_family_serve` judges it); the
    routes of the cached and the uncached path are counted
    (:func:`route_diff`; none may differ in the first MoE layer), and the
    two yardsticks are taken with the routes the served run chose
    (:class:`pinned_routes`), so that every position is judged: in
    bfloat16 the two paths' routes part at the first positions of a
    28-layer random DeepSeek-MoE (a float32 router on bfloat16 rows that
    other row counts round otherwise), where holding only the positions
    before the first differing route holds none.  The served routes are
    then held to the pinned yardsticks' own routers (:func:`route_gate`).
    Then the decode step alone (:func:`time_decode_steps`), beside its
    byte bound (:func:`decode_bound`).  Returns the line and the launch
    counts (set to 0 just before ``generate``, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    cuda = torch.device(device).type == "cuda"
    cfg = get_config(spec.arch)
    if spec.layers:
        cfg = dataclasses.replace(cfg, n_layers=spec.layers)
    moe = bool(cfg.n_experts)
    if moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    resident = _reset_peak(device)
    t0 = time.perf_counter()
    model, params = make_lm(SEED, spec, device, cfg=cfg, dtype="bfloat16")
    sync(device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 3)
    masks = M.as_device({k: (rng.random(s.shape) < 0.9).astype(np.float32)
                         for k, s in model.mask_sites().items()}, device)
    prompts = torch.from_numpy(MarkovTokens(cfg.vocab, seed=SEED + 3).batch(
        batch, prompt, 0)["tokens"]).long().to(device)
    build.reset_launch_counts()
    with record_routes() as cached_routes:
        gen = serve.generate(model, params, masks, prompts, n_gen,
                             ties=False, keep_logits=True)
    sync(device)
    launches = counts()
    toks = gen["tokens"].long()
    n = prompt + n_gen - 1
    width = -(-n // spec.pad) * spec.pad
    seq = torch.cat([prompts, toks[:, :-1],
                     prompts.new_zeros((batch, width - n))], dim=1)
    where = f"{spec.tag}_bf16_serve"
    routes = None
    pin_bf = pin_32 = contextlib.nullcontext()
    if moe:
        with torch.no_grad(), record_routes() as uncached_routes:
            model.forward(params, masks, seq, ties=False)
        routes, served = route_diff(cached_routes.calls,
                                    uncached_routes.calls, n_gen, n)
        del uncached_routes
        if routes["routes_differ_by_layer"][0]:
            fail(f"{where}: the first MoE layer routes otherwise cached "
                 f"and uncached: {routes}")
        pin_bf, pin_32 = pinned_routes(served), pinned_routes(served)
    bound = decode_bound(model, params, cached_routes.calls, n_gen)
    del cached_routes
    with torch.no_grad(), pin_bf:
        full = model.forward(params, masks, seq, ties=False)[:, prompt - 1:n]
    with pin_32:
        exact = upcast_logits(model, params, masks, seq)[:, prompt - 1:n]
    if moe:
        routes["gate"] = route_gate(served, pin_bf, pin_32, where)
        del served, pin_bf, pin_32
    kept = torch.stack(gen["logits"], dim=1)             # (B, n_gen, V)
    check = judge_bf16(kept.flatten(0, 1), full.flatten(0, 1),
                       exact.flatten(0, 1), toks.flatten(), where)
    dec = gen["decode_ms"]
    out = dict(model=cfg.name, dtype="bfloat16", layers=cfg.n_layers,
               batch=batch, prompt=prompt, gen=n_gen, init_s=init_s,
               prefill_ms=gen["prefill_ms"],
               decode_ms_mean=float(np.mean(dec)),
               decode_ms_min=float(np.min(dec)), decode_steps=len(dec),
               tokens_per_s=batch * 1e3 / float(np.mean(dec)),
               param_bytes=param_bytes(params), **bound, check=check)
    if spec.w_o_scale != 1.0:
        out["w_o_scale"] = spec.w_o_scale
    if moe:
        out["capacity_factor"] = cfg.capacity_factor
        out["routes_cached_vs_uncached"] = routes
    del gen, full, exact, kept
    if cuda:
        out["decode_step"] = time_decode_steps(model, params, masks, prompts,
                                               device)
        out["memory"] = _peak(device, resident)
    del model, params, masks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, launches


def argmax_ties(device="cuda"):
    """``torch.argmax`` on bfloat16 logits of a 100,352-token vocabulary
    with the largest value made to tie at several indices: the first index
    of the tie, as ``jnp.argmax`` takes it (the served token and the
    uncached argmax are both taken so)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    logits = torch.randn((4, 100352), generator=g, device=device).to(
        torch.bfloat16)
    ties = torch.tensor([[7, 50000, 100351], [0, 1, 2], [99, 98, 100000],
                         [65535, 65536, 70000]], device=device)
    logits.scatter_(1, ties, torch.full(ties.shape, 8.0, device=device,
                                        dtype=torch.bfloat16))
    got = logits.argmax(-1).tolist()
    want = ties.amin(-1).tolist()
    if got != want:
        fail(f"serve: argmax of tied bfloat16 logits gave {got}, not the "
             f"first index {want}")
    return dict(rows=4, vocab=100352, tied_at=ties.tolist(), argmax=got)


LAUNCHER_TIMEOUT_S = 600


def run_serve_launcher():
    """``python -m repro_torch.launch.serve --arch stablelm_1p6b`` as a user
    runs it on the card, with no ``--reduced`` and no ``--device``, in a
    child process: it must exit 0, serve the published config in its own
    bfloat16 on the card and print its tokens/s."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "stablelm_1p6b", *LAUNCHER_FLAGS]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")] +
        ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    proc, wall = _child(cmd, env, LAUNCHER_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    model = next((x for x in lines if x.startswith("model ")), "")
    rate = next((x for x in lines if "tok/s" in x), "")
    if proc.returncode != 0 or "dtype=bfloat16" not in model or \
            "device=cuda" not in model or not rate:
        fail(f"serve launcher: exit {proc.returncode}, stdout "
             f"{lines[-6:]}, stderr {proc.stderr.strip().splitlines()[-6:]}")
    return dict(command=" ".join(["python", "-m", "repro_torch.launch.serve",
                                  "--arch", "stablelm_1p6b",
                                  *LAUNCHER_FLAGS]),
                wall_s=wall, model_line=model, rate_line=rate)


def run_serve_path(by_path, device="cuda"):
    """The serving slice: StableLM-2-1.6B's continuous-batching loop,
    RWKV-6 3B's batched prefill + decode and its exact-length loop (their
    launch counts summed into ``by_path["serve"]``), and the reduced chaos
    drill on the card and on the CPU; then the configs' own bfloat16
    (``by_path["serve_bf16"]``): StableLM-2-1.6B's loop, ``generate`` on
    RWKV-6 3B, DeepSeek-MoE-16B and Zamba2-2.7B at their LM paths' depths
    (``SERVE_BF16_LAYERS`` where not), a tie of bfloat16 logits, and the
    launcher as a user runs it."""
    t0 = time.perf_counter()
    lm, lm_counts = run_serve_stablelm(device)
    lm["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    rwkv, rwkv_counts = run_serve_rwkv(device)
    rwkv["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    by_path["serve"] = {k: lm_counts[k] + rwkv_counts[k] for k in lm_counts}
    drill = run_chaos_drill(device)
    drill["seconds"] = time.perf_counter() - t0
    out = dict(stablelm=lm, rwkv=rwkv, chaos_drill=drill,
               launches={k: v for k, v in by_path["serve"].items() if v})
    t0 = time.perf_counter()
    bf16 = {"argmax_ties": argmax_ties(device), "lines": []}
    t1 = time.perf_counter()
    line, total = run_serve_stablelm(
        device, dtype="bfloat16",
        layers=SERVE_BF16_LAYERS.get(LM_PATHS[0].arch, 0))
    line["seconds"] = time.perf_counter() - t1
    emit({"lm_bf16_serve": line})
    bf16["lines"].append("lm_bf16_serve")
    for spec, (b, p, g) in zip(LM_PATHS[1:] + FAMILY_PATHS,
                               SERVE_BF16_GENERATE):
        spec = dataclasses.replace(
            spec, layers=SERVE_BF16_LAYERS.get(spec.arch, spec.layers))
        t1 = time.perf_counter()
        line, launches = run_serve_generate_bf16(spec, b, p, g, device)
        line["seconds"] = time.perf_counter() - t1
        emit({f"{spec.tag}_bf16_serve": line})
        bf16["lines"].append(f"{spec.tag}_bf16_serve")
        total = {k: total[k] + launches[k] for k in total}
    if torch.device(device).type == "cuda":
        emit({"serve_launcher": run_serve_launcher()})
        bf16["lines"].append("serve_launcher")
    by_path["serve_bf16"] = total
    bf16["launches"] = {k: v for k, v in total.items() if v}
    bf16["seconds"] = time.perf_counter() - t0
    out["bfloat16"] = bf16
    return out


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
# the card-vs-CPU gradient check of a bfloat16 family sweep: lm_train's
# bfloat16 rule (each leaf's relative L2 error against the CPU's float32
# gradient of the upcast parameters within LM_TRAIN_BF16_GRAD_RATIO times
# the CPU's own bfloat16 gradient's, plus LM_TRAIN_BF16_GRAD_ABS), on the
# family cut to its head blocks and its first ``grad_repeats`` repeats;
# on a MoE, these leaves are held over the experts that no (token, k)
# route differing between the card's forward and the CPU's reached
MOE_ROUTED_LEAVES = ("router", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class FamilySweep:
    spec: LMPath        # the LM path's config, tag and output scaling
    engines: tuple      # the engines swept, from one persisted warm start
    layers: int = 0     # n_layers cut (0: every layer)
    lr_scale: float = 1.0   # factor on the example's learning rates
    lr_why: str = ""    # the loss seen first at the example's own
    dtype: str = "float32"  # the model's dtype (bfloat16: the config's own)
    grad_repeats: int = 0   # depth of the card-vs-CPU check (0: none)
    layers_why: str = "the script's time and its disk writes"

    @property
    def tag(self) -> str:
        """The line's tag: ``<path tag>`` in float32, ``<path tag>_bf16``
        in bfloat16."""
        return self.spec.tag + ("_bf16" if self.dtype == "bfloat16" else "")


_PAYS = "the script's time: cut to pay for the bfloat16 sweeps"
_LIMIT = "the script's 1,200 s limit, with room for slower hosts"
FAMILY_SWEEPS = (
    # float32, each family as shallow as still drives its path: 2 of 32
    # RWKV-6 repeats (the depth of the float32 gradient check) and the
    # dense head block and 2 MoE repeats of DeepSeek, so that each has a
    # repeat r >= 1 for the example's mid-scan timing (the suffix engine's
    # carry-checkpointed sited chunks: kernel 4 on DeepSeek's shared
    # experts), and 1 of Zamba2's 9 repeats.  At 8 repeats, 4 layers and
    # all 54 layers the three took 78.6, 110.3 and 147.8 s on one H100
    FamilySweep(LM_PATHS[1], ("batched", "suffix"), layers=2,
                layers_why=_PAYS, grad_repeats=FAMILY_GRAD_REPEATS),
    FamilySweep(FAMILY_PATHS[0], ("batched", "suffix"), layers=3,
                layers_why=_PAYS),
    # at the example's learning rates (tuned on the reduced configs),
    # SNL's SGD at 1e-2 turned the full-width model's loss to NaN in its
    # first epoch (10.88 after training; measured on one H100)
    FamilySweep(FAMILY_PATHS[1], ("batched", "suffix"), layers=6,
                lr_scale=1 / 32,
                lr_why="at the example's own, the loss after SNL was NaN "
                       "(10.88 after training)", layers_why=_PAYS),
    # the configs' own bfloat16, the same seed's draws rounded, at the
    # float32 sweeps' depths (AdamW's state for all 16.2 B DeepSeek
    # parameters fits no single card).  The host-bound sweeps took 77.6,
    # 112.3 and 102.5 s at 8 repeats, 4 layers and 36 layers on one H100
    # (146-176 s for Zamba2 at 54), and with them the script came within
    # 230 s of its 1,200 s limit on one host and went past it on another;
    # at 4 repeats, 3 and 12 layers it took 852 and 991 s on two hosts
    FamilySweep(LM_PATHS[1], ("batched", "suffix"), layers=2,
                dtype="bfloat16", grad_repeats=2, layers_why=_LIMIT),
    FamilySweep(FAMILY_PATHS[0], ("batched", "suffix"), layers=3,
                dtype="bfloat16", grad_repeats=1, layers_why=_LIMIT),
    FamilySweep(FAMILY_PATHS[1], ("suffix",), layers=6, lr_scale=1 / 32,
                lr_why="at the example's own, the float32 loss after SNL "
                       "was NaN (10.88 after training)",
                dtype="bfloat16", grad_repeats=1, layers_why=_LIMIT),
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


def _moe_layers(cfg):
    """The leaf prefix of each MoE block in forward order, with its stack
    repeat (None for a head or tail block): the order in which
    :class:`record_routes` records their routings."""
    out = [(f"head.{i}.moe", None) for i, b in enumerate(cfg.head_blocks)
           if b.kind == "moe"]
    for r in range(cfg.n_repeats):
        out += [(f"stack.{pos}.moe", r) for pos, b in enumerate(cfg.pattern)
                if b.kind == "moe"]
    return out + [(f"tail.{i}.moe", None) for i, b in enumerate(cfg.tail)
                  if b.kind == "moe"]


def _by_expert(name, t, r):
    """A routed leaf (``MOE_ROUTED_LEAVES``) with its repeat ``r`` taken
    (None: no repeat axis) and its expert axis first: the router's last
    axis, an expert weight's first."""
    if r is not None:
        t = t[r]
    return t.movedim(-1, 0) if name.endswith(".router") else t


def family_grad_check(model, params, ex, repeats: int, device="cuda"):
    """One train step's gradients of a family at full width, cut to its
    head blocks and first ``repeats`` repeats (:func:`first_repeats`), on
    the card (the gates' backward on ``gate_bwd_kernel``, RWKV-6's scans
    through ``rwkv6_scan_bwd``) and on the CPU (the plain versions), from
    the same parameters, random hard masks and the example's first batch.
    The rule follows the model's dtype:

    * float32: each leaf's relative L2 error within ``FAMILY_GRAD_TOL`` of
      the CPU's gradient;
    * bfloat16 (``lm_train``'s rule): each leaf's relative L2 error
      against the CPU's float32 gradient of the same parameters, upcast,
      within ``LM_TRAIN_BF16_GRAD_RATIO`` times the CPU's own bfloat16
      gradient's, plus ``LM_TRAIN_BF16_GRAD_ABS``.

    On a MoE the (token, k) routes of the card's forward and the CPU's are
    counted; in each MoE layer where some differ, the routed leaves
    (``MOE_ROUTED_LEAVES``: the router and the routed experts, not the
    shared expert) are held over the experts that no differing token
    reached (neither path chose them for it: its gates renormalise over
    the experts it chose) and the experts left out are reported."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    rng = np.random.default_rng(SEED)
    tree = {k: (rng.random(s.shape) < 0.6).astype(np.float32)
            for k, s in model.mask_sites().items()}
    cut, sub, sub_tree = first_repeats(model, params, tree, repeats)
    bf16 = cut.dtype == torch.bfloat16
    args = ex.parse_args(["--out-dir", "unused"] + list(FAMILY_FLAGS))
    batch = MarkovTokens(cut.cfg.vocab, seed=0).batch(args.batch, args.seq,
                                                      0)
    names = opt_lib.tree_leaves(_leaf_names(sub))
    where = f"family_grad {cut.cfg.name} {cut.cfg.dtype}"

    def grads(m, p, dev):
        def loss_fn(q, a, b):
            return train.cross_entropy(m.forward(q, a, b["tokens"]),
                                       b["labels"])
        with record_routes() as rec, train.deterministic():
            loss, g = train.loss_and_grads(loss_fn, p,
                                           M.as_device(sub_tree, dev),
                                           to_device(batch, dev))
        g = [t.float().cpu() for t in opt_lib.tree_leaves(g)]
        for name, t in zip(names, g):
            if not bool(torch.isfinite(t).all()):
                fail(f"{where}: the {dev} gradient of {name} is not finite")
        return float(loss), g, [r[0].cpu() for r in rec.calls]
    before = counts()
    loss_card, g_card, r_card = grads(cut, sub, device)
    sync(device)
    launched = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    sub_cpu = to_device(sub, "cpu")
    loss_cpu, g_cpu, r_cpu = grads(cut, sub_cpu, "cpu")
    if bf16:
        cut32 = LM(dataclasses.replace(cut.cfg, dtype="float32"))
        loss_32, g_32, r_32 = grads(
            cut32, opt_lib.tree_map(lambda t: t.float(), sub_cpu), "cpu")
    del sub_cpu
    # the routed leaves' experts that a differing (token, k) route reached
    moe_layers = _moe_layers(cut.cfg)
    if len(moe_layers) != len(r_cpu):
        fail(f"{where}: {len(r_cpu)} routings for {len(moe_layers)} MoE "
             "layers")
    E = cut.cfg.n_experts
    held = {}               # leaf name -> (repeat or None, held experts)
    excluded = {}
    for (prefix, r), a, b in zip(moe_layers, r_card, r_cpu):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        diff = (a != b).any(-1)
        reached = torch.zeros(E, dtype=torch.bool)
        reached[torch.cat([a[diff], b[diff]]).unique()] = True
        excluded[prefix if r is None else f"{prefix}[{r}]"] = \
            int(reached.sum())
        for leaf in MOE_ROUTED_LEAVES:
            held.setdefault(f"{prefix}.{leaf}", []).append((r, ~reached))

    def sliced(gs):
        out = []
        for name, t in zip(names, gs):
            if name in held:
                t = torch.cat([_by_expert(name, t, r)[keep]
                               for r, keep in held[name]])
            out.append(t)
        return out
    g_card, g_cpu = sliced(g_card), sliced(g_cpu)
    out = dict(model=cut.cfg.name, dtype=cut.cfg.dtype,
               layers=cut.cfg.n_layers, of=model.cfg.n_layers,
               repeats=repeats, batch=[args.batch, args.seq],
               leaves=len(names), loss_card=loss_card, loss_cpu=loss_cpu,
               launched=launched)
    if r_cpu:
        out["routes"] = dict(
            card_vs_cpu=sum(int((a != b).sum())
                            for a, b in zip(r_card, r_cpu)),
            compared=sum(a.numel() for a in r_cpu), moe_layers=len(r_cpu),
            experts_not_held_by_layer=excluded, of_experts=E)
        if bf16:
            out["routes"]["cpu_vs_cpu_float32"] = sum(
                int((a != b).sum()) for a, b in zip(r_cpu, r_32))
    if bf16:
        rule, ok = bf16_grad_rule(names, g_card, g_cpu, sliced(g_32))
        out.update(rule, loss_cpu_f32=loss_32)
        bad = not ok
    else:
        card = _rel_l2_leaves(names, g_card, g_cpu)
        worst = max(card, key=card.get)
        out.update(worst_leaf=worst, worst_l2_rel=card[worst],
                   tol=FAMILY_GRAD_TOL, l2_rel_by_leaf=card)
        bad = card[worst] > FAMILY_GRAD_TOL
    if bad:
        fail(f"{where}: {out}")
    needed = ["masked_act_2d_bwd"] + (
        ["rwkv6_scan_bwd"] if model.cfg.pattern[0].kind == "rwkv" else [])
    for k in needed:
        if torch.device(device).type == "cuda" and not launched.get(k):
            fail(f"{where}: the card's step launched no {k}")
    return out


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
            # (in bfloat16 the probe's 1e-7 relative noise rounds away)
            if self.spec.w_o_scale != 1.0 and \
                    self.model.dtype == torch.float32:
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
    model, params = make_lm(SEED, spec, device, cfg=cfg, dtype=fam.dtype)
    sync(device)
    line = dict(model=model.cfg.name, dtype=fam.dtype,
                layers=model.cfg.n_layers, param_bytes=param_bytes(params),
                init_s=time.perf_counter() - t0, engines=list(fam.engines),
                flags=list(FAMILY_FLAGS))
    t0 = time.perf_counter()
    grad = family_grad_check(model, params, ex, fam.grad_repeats, device) \
        if fam.grad_repeats else None
    if grad is not None:
        grad["seconds"] = time.perf_counter() - t0
    dirs = {e: os.path.join(root, f"{fam.tag}_{e}") for e in fam.engines}
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
    # where the suffix engine may site a chunk, for the cost_model line
    line["chunk_size"] = args.chunk_size
    line["site_prefix_fractions"] = model.site_prefix_fractions()

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
            fail(f"{fam.tag}_family_sweep ({e}): the sweep did not "
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
            emit({f"{fam.tag}_family_sweep_failed": line})
            fail(f"{fam.tag}_family_sweep ({e}): losses after the stages "
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
            fail(f"{fam.tag}_family_sweep: the engines' {what} differ: "
                 f"{got}")
    ft = {e: r["finetune_losses"] for e, r in runs.items()}
    if len({tuple(v) for v in ft.values()}) != 1:
        fail(f"{fam.tag}_family_sweep: the engines' losses after their "
             f"finetunes differ: {ft}")
    launches = counts()
    line.update(runs=runs, engines_agree=len(fam.engines) > 1 or None,
                launches={k: v for k, v in launches.items() if v})
    if cuda:
        line["max_allocated"] = peak
        line["device_total"] = torch.cuda.get_device_properties(0) \
            .total_memory
        if line["max_allocated"] >= line["device_total"]:
            fail(f"{fam.tag}_family_sweep: peak allocated "
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
            "the config's own bfloat16, the seed's draws rounded"
            if fam.dtype == "bfloat16" else
            "float32 (the config's own bfloat16 is the "
            f"{fam.spec.tag}_bf16_family_sweep line)"]
    if fam.layers:
        from repro_torch.configs import get_config
        full = get_config(fam.spec.arch).n_layers
        heads = len(model.cfg.head_blocks)
        reps = (fam.layers - heads) // len(model.cfg.pattern)
        what = f"the dense head block and {reps} MoE repeats" if heads \
            else f"{reps} of {full // len(model.cfg.pattern)} repeats"
        cuts.append(f"{fam.layers} of {full} layers: {what} "
                    f"({fam.layers_why})")
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
    if fam.grad_repeats:
        cuts.append(f"the card-vs-CPU gradient check on the first "
                    f"{fam.grad_repeats} repeats (and the head blocks)")
    return cuts


def cost_model_line(lines, history, backend):
    """The suffix cost model calibrated from this run's own bench history
    (``SuffixCostModel.calibrated``, fingerprint ``{"model", "dtype",
    "backend"}``, so one dtype's timings do not move another's points)
    for each family and dtype whose sweeps wrote a mid-scan line, under
    ``families[model][dtype]``: its measured points and, at each of the
    family's sites (their prefix fractions), the analytic model's and the
    calibrated model's ``use_suffix`` for a chunk of the sweep's size.
    Host only.  Fails where such a family calibrates to nothing
    (``measured=None``)."""
    from repro_torch.analysis.roofline import SuffixCostModel
    t0 = time.perf_counter()
    wrote = {}
    for line in lines:
        rows = [r["midscan"] for r in line["runs"].values()
                if r.get("midscan")]
        if rows:
            key = (line["model"], line["dtype"])
            wrote.setdefault(key, (line, []))[1].extend(rows)
    analytic = SuffixCostModel()
    families = {}
    for (name, dtype), (line, rows) in wrote.items():
        cm = SuffixCostModel.calibrated(history, fingerprint={
            "model": name, "dtype": dtype, "backend": backend})
        if cm.measured is None:
            fail(f"cost_model: {name}'s {dtype} sweeps wrote {len(rows)} "
                 f"mid-scan line(s), but SuffixCostModel.calibrated("
                 f"{history!r}) found no measured point")
        n = line["chunk_size"]
        fracs = sorted(line["site_prefix_fractions"].items(),
                       key=lambda kv: (kv[1], kv[0]))
        families.setdefault(name, {})[dtype] = dict(
            midscan_lines=len(rows), chunk=n,
            measured=[list(p) for p in cm.measured],
            sites=[dict(site=site, prefix_fraction=f,
                        analytic=analytic.use_suffix(f, n),
                        calibrated=cm.use_suffix(f, n),
                        predicted_speedup=cm.predicted_speedup(f, n))
                   for site, f in fracs])
    return dict(history=history, backend=backend, families=families,
                seconds=time.perf_counter() - t0)


def run_family_path(by_path, device="cuda", only=None):
    """The family path: the three families' sweeps (``FAMILY_SWEEPS``),
    in float32 and in the configs' own bfloat16, their launch counts
    summed into ``by_path["family_sweep"]`` and
    ``by_path["family_sweep_bf16"]`` (``only``: one family's tag, both
    dtypes, or one sweep's, e.g. ``rwkv_bf16``, to run it alone), then the
    ``cost_model`` line on the bench history the sweeps wrote.  Run
    directories live under ``build/family_sweep`` of this checkout (tens
    of GB of checkpoints at full width), removed at the end."""
    import shutil
    ex = load_family_example()
    # what the earlier paths left behind goes before the families'
    # parameters and their AdamW state arrive
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
    totals = {}
    lines = []
    try:
        for fam in FAMILY_SWEEPS:
            if only is not None and only not in (fam.spec.tag, fam.tag):
                continue
            t0 = time.perf_counter()
            with scaled_learning_rates(ex, fam.lr_scale):
                line, launches = run_family_sweep(fam, ex, root, device)
            line["seconds"] = time.perf_counter() - t0
            emit({f"{fam.tag}_family_sweep": line})
            lines.append(line)
            path = "family_sweep_bf16" if fam.dtype == "bfloat16" \
                else "family_sweep"
            total = totals.get(path)
            totals[path] = launches if total is None else \
                {k: total[k] + launches[k] for k in total}
        cuda = torch.device(device).type == "cuda"
        emit({"cost_model": cost_model_line(
            lines, os.path.join(root, "BENCH_history.jsonl"),
            torch.cuda.get_device_name(0) if cuda else "cpu")})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path.update(totals)
    return lines


# ------------------------------------------------------- training an LM


# the launcher at StableLM-2-1.6B's published widths, in its own
# bfloat16: 8 steps of 8 x 128 tokens, one checkpoint (the final one:
# parameters and AdamW's two moments), on 12 of its 24 layers
# (``LM_TRAIN_LAYERS``; all 24 before, 8.63 GB a checkpoint, the phase
# 81.6 s on one H100): the script's time, with the sharded phases added,
# had come to 879 s of its 1,200
LM_TRAIN_LAYERS = 12
LM_TRAIN_FLAGS = ("--arch", "stablelm_1p6b", "--steps", "8",
                  "--global-batch", "8", "--seq", "128", "--mesh", "1,1",
                  "--ckpt-every", "8")
LM_TRAIN_CHUNK = 32             # loss_chunk against the whole sequence
LM_TRAIN_LOSS_REL = 1e-5        # ... its loss (the reference's own test)
LM_TRAIN_NORM_REL = 1e-3        # ... and its grad_norm
LM_TRAIN_GRAD_LAYERS = 2        # card vs CPU: 2 of 24 layers, batch 2
LM_TRAIN_GRAD_BATCH = 2
# ... in bfloat16 (the config's own dtype): each leaf's relative L2 error
# against the CPU's float32 gradient (of the same bfloat16 parameters,
# upcast) within twice the CPU's bfloat16 gradient's, plus 2^-5 — the
# pattern of tests/test_torch_train_bf16.py
LM_TRAIN_BF16_GRAD_RATIO, LM_TRAIN_BF16_GRAD_ABS = 2.0, 2.0 ** -5
# loss_chunk against the whole sequence in bfloat16: the logits are
# bfloat16 products that cuBLAS may sum in another order at another row
# count, each rounding to bfloat16 (2^-8)
LM_TRAIN_BF16_LOSS_REL, LM_TRAIN_BF16_NORM_REL = 2.0 ** -8, 2.0 ** -6
# the supervisor drill at --reduced width: 20 steps, again with a failure
# at step 13 (restart from the step-10 checkpoint), then a rerun to 25
DRILL_FLAGS = ("--arch", "stablelm_1p6b", "--reduced", "--global-batch",
               "8", "--seq", "64", "--ckpt-every", "5", "--mesh", "1,1")
DRILL_STEPS, DRILL_FAIL_AT, DRILL_RESUME_STEPS = 20, 13, 25
TRAIN_LM_EXAMPLE = os.path.join(HERE, "examples", "torch_train_lm.py")


def _clone_state(state):
    from repro_torch.training import optimizer as opt_lib
    o = state["opt"]
    return {"params": opt_lib.tree_map(torch.clone, state["params"]),
            "opt": opt_lib.OptState(o.step.clone(),
                                    opt_lib.tree_map(torch.clone, o.mu),
                                    opt_lib.tree_map(torch.clone, o.nu)),
            "step": state["step"].clone()}


def _state_leaves(state):
    """``(key, leaf)`` of a train state, in the checkpoint's order."""
    from repro_torch.training import checkpoint
    return checkpoint._flatten(state)


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (a bfloat16 -0 is not +0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.detach().cpu().reshape(-1).view(torch.uint8),
                       b.detach().cpu().reshape(-1).view(torch.uint8))


def _peak(device, before):
    """Peak allocated bytes since the last reset, and the peak less what
    was allocated before (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated()
    return dict(peak_bytes=peak, over_resident_bytes=peak - before)


def _reset_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _rel_l2_leaves(names, got, want) -> dict:
    """Each leaf's relative L2 error of ``got`` against ``want`` (lists of
    host tensors), in float64."""
    out = {}
    for name, g, w in zip(names, got, want):
        den = float(torch.linalg.vector_norm(w.double()))
        out[name] = float(torch.linalg.vector_norm(
            g.double() - w.double())) / max(den, 1e-30)
    return out


def bf16_grad_rule(names, card, cpu, f32):
    """The bfloat16 gradient rule over leaf lists (host tensors): each
    leaf's relative L2 error of the card's bfloat16 gradient ``card``
    against the CPU's float32 gradient of the same parameters, upcast
    (``f32``), within ``LM_TRAIN_BF16_GRAD_RATIO`` times the CPU's own
    bfloat16 gradient's (``cpu``), plus ``LM_TRAIN_BF16_GRAD_ABS``.
    Returns the report at the leaf closest to its bound, and whether every
    leaf is within it."""
    c = _rel_l2_leaves(names, card, f32)
    h = _rel_l2_leaves(names, cpu, f32)
    excess = {n: c[n] - (LM_TRAIN_BF16_GRAD_RATIO * h[n] +
                         LM_TRAIN_BF16_GRAD_ABS) for n in names}
    worst = max(excess, key=excess.get)
    return dict(worst_leaf=worst, card_rel_l2_vs_cpu_f32=c[worst],
                cpu_rel_l2_vs_cpu_f32=h[worst],
                max_card_rel_l2_vs_cpu_f32=max(c.values()),
                max_cpu_rel_l2_vs_cpu_f32=max(h.values()),
                tol=f"card <= {LM_TRAIN_BF16_GRAD_RATIO} * cpu + 2^-5 "
                    "(relative L2 against the CPU's float32 gradient)"), \
        excess[worst] <= 0


def lm_train_grad_check(model, params, batch, device="cuda"):
    """The train step's loss gradients of the model cut to its first
    ``LM_TRAIN_GRAD_LAYERS`` layers, on the card (the gates through
    ``gate_bwd_kernel``) and on the CPU (the plain versions), from the same
    parameters, random hard masks and batch, remat on.  In float32 (the
    parameters upcast): each leaf's relative L2 error within
    ``FAMILY_GRAD_TOL``.  In the model's bfloat16: each leaf's relative L2
    error against the CPU's float32 gradient within
    ``LM_TRAIN_BF16_GRAD_RATIO`` times the CPU's bfloat16 gradient's, plus
    ``LM_TRAIN_BF16_GRAD_ABS``."""
    from repro_torch.convert import to_device
    from repro_torch.core import masks as M
    from repro_torch.models.lm import LM
    from repro_torch.training import optimizer as opt_lib, train
    rng = np.random.default_rng(SEED)
    tree = {k: (rng.random(s.shape) < 0.6).astype(np.float32)
            for k, s in model.mask_sites().items()}
    cut, sub, sub_tree = first_repeats(model, params, tree,
                                       LM_TRAIN_GRAD_LAYERS)
    names = opt_lib.tree_leaves(_leaf_names(sub))

    def grads(m, p, dev):
        loss_fn = train.make_loss_fn(m, train.TrainStepCfg(remat=True))
        with train.deterministic():
            loss, g = train.loss_and_grads(
                loss_fn, to_device(p, dev), M.as_device(sub_tree, dev),
                to_device(batch, dev))
        g = [t.cpu() for t in opt_lib.tree_leaves(g)]
        for name, t in zip(names, g):
            if not bool(torch.isfinite(t).all()):
                fail(f"lm_train: the {dev} gradient of {name} is not "
                     "finite")
        return float(loss), g
    cut32 = LM(dataclasses.replace(cut.cfg, dtype="float32"))
    sub32 = opt_lib.tree_map(lambda t: t.float(), sub)
    loss_c, g_card = grads(cut32, sub32, device)
    loss_h, g_cpu = grads(cut32, sub32, "cpu")
    per_leaf = _rel_l2_leaves(names, g_card, g_cpu)
    worst = max(per_leaf, key=per_leaf.get)
    if per_leaf[worst] > FAMILY_GRAD_TOL:
        fail(f"lm_train: card vs CPU float32 gradient of {worst}: relative "
             f"L2 {per_leaf[worst]:.3e} > {FAMILY_GRAD_TOL}")
    out = dict(layers=cut.cfg.n_layers, of=model.cfg.n_layers,
               batch=list(batch["tokens"].shape), leaves=len(per_leaf),
               float32=dict(worst_leaf=worst, worst_rel_l2=per_leaf[worst],
                            tol=FAMILY_GRAD_TOL, loss_card=loss_c,
                            loss_cpu=loss_h))
    del g_card, sub32
    if cut.dtype != torch.bfloat16:
        return out
    loss_bc, g_bcard = grads(cut, sub, device)
    loss_bh, g_bcpu = grads(cut, sub, "cpu")
    rule, ok = bf16_grad_rule(names, g_bcard, g_bcpu, g_cpu)
    direct = _rel_l2_leaves(names, g_bcard, g_bcpu)
    out["bfloat16"] = dict(
        rule, max_card_vs_cpu_bf16_rel_l2=max(direct.values()),
        loss_card=loss_bc, loss_cpu=loss_bh)
    if not ok:
        fail(f"lm_train: card vs CPU bfloat16 gradient of "
             f"{rule['worst_leaf']}: {out['bfloat16']}")
    return out


def lm_train_from_one_state(model, state, batch, masks, opt, device):
    """From one train state: gradients with remat on and off (equal to the
    bit), ``quantize_grads_int8`` of them on the card and on the CPU
    (equal to the bit), a step each with remat on and off from copies of
    the state (equal parameters and moments), and a step with
    ``loss_chunk`` (loss and grad_norm within the reference's bounds)."""
    from repro_torch.training import optimizer as opt_lib, train
    out, peaks = {}, {}
    cfgs = {"remat": train.TrainStepCfg(remat=True),
            "no_remat": train.TrainStepCfg(remat=False),
            "chunk": train.TrainStepCfg(remat=True,
                                        loss_chunk=LM_TRAIN_CHUNK)}
    grads = {}
    for tag in ("remat", "no_remat"):
        before = _reset_peak(device)
        with train.deterministic():
            loss, g = train.loss_and_grads(
                train.make_loss_fn(model, cfgs[tag]), state["params"],
                masks, batch)
        sync(device)
        grads[tag] = opt_lib.tree_leaves(g)
        peaks[f"grads_{tag}"] = _peak(device, before)
        out[f"loss_{tag}"] = float(loss)
        del g
    out["grads_equal_bits"] = all(_same_bits(a, b) for a, b in zip(
        grads["remat"], grads["no_remat"])) and \
        out["loss_remat"] == out["loss_no_remat"]
    if not out["grads_equal_bits"]:
        fail("lm_train: the gradients with remat differ from those "
             "without")
    del grads["no_remat"]
    # compress_grads: the card's quantization against the CPU's, leaf by
    # leaf on the same gradients
    t0 = time.perf_counter()
    differ = 0
    for g in grads.pop("remat"):
        q_card = train.quantize_grads_int8([g])[0].cpu()
        q_cpu = train.quantize_grads_int8([g.cpu()])[0]
        differ += int(not _same_bits(q_card, q_cpu))
    out["quantize_int8"] = dict(leaves_differing=differ,
                                seconds=time.perf_counter() - t0)
    if differ:
        fail(f"lm_train: quantize_grads_int8 on the card differs from the "
             f"CPU's in {differ} leaves")
    gc.collect()
    # a step each from copies of the state
    new, metrics = {}, {}
    for tag in ("remat", "no_remat", "chunk"):
        s = _clone_state(state)
        before = _reset_peak(device)
        new[tag], m = train.make_train_step(model, opt, cfgs[tag])(
            s, batch, masks)
        sync(device)
        peaks[f"step_{tag}"] = _peak(device, before)
        metrics[tag] = {k: float(v) for k, v in m.items()}
        if tag == "no_remat":
            same = all(
                ka == kb and _same_bits(a, b) for (ka, a), (kb, b) in zip(
                    _state_leaves(new["remat"]), _state_leaves(new[tag])))
            out["step_equal_bits"] = same and metrics["remat"] == metrics[tag]
            if not out["step_equal_bits"]:
                fail("lm_train: a step with remat gave other parameters, "
                     "moments or metrics than one without")
        if tag != "remat":
            del new[tag]
    del new
    whole, chunk = metrics["remat"], metrics["chunk"]
    rel = {k: abs(chunk[k] - whole[k]) / abs(whole[k])
           for k in ("loss", "grad_norm")}
    tol_loss, tol_norm = (LM_TRAIN_BF16_LOSS_REL, LM_TRAIN_BF16_NORM_REL) \
        if model.dtype == torch.bfloat16 else (LM_TRAIN_LOSS_REL,
                                               LM_TRAIN_NORM_REL)
    out["loss_chunk"] = dict(chunk=LM_TRAIN_CHUNK, whole=whole, chunked=chunk,
                             rel=rel, tol={"loss": tol_loss,
                                           "grad_norm": tol_norm})
    if rel["loss"] > tol_loss or rel["grad_norm"] > tol_norm:
        fail(f"lm_train: loss_chunk={LM_TRAIN_CHUNK} against the whole "
             f"sequence: {rel}")
    out["peaks"] = peaks
    gc.collect()
    return out


def profile_lm_train_step(step, state, batch_fn, masks, device):
    """One step under the profiler after one that warms up
    (:func:`profile_window`: device busy share, launches a step), then one
    outside it, timed on the host until ``train_step`` returns (the host
    issuing it) and until the card is done.  Consumes ``state``."""
    holder = {"s": state}

    def one(i):
        holder["s"], _ = step(holder["s"], batch_fn(i), masks)
    prof = profile_window(one, 1)
    b = batch_fn(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    holder["s"], m = step(holder["s"], b, masks)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del holder["s"]
    return dict(profile=prof, issue_ms=(t1 - t0) * 1e3,
                step_ms=(t2 - t0) * 1e3, host_share=(t1 - t0) / (t2 - t0),
                loss=float(m["loss"]))


def run_supervisor_drill(root, device="cuda", dtype="bfloat16"):
    """The launcher at ``--reduced`` width in ``dtype`` (the config's own
    is bfloat16; ``--reduced`` sets float32): 20 steps, the same 20 with a
    failure injected at step 13 (a restart from the checkpoint of step
    10), equal losses from step 10 on and equal final parameters, moments
    and counters; then a rerun with 25 steps in the first run's directory
    resumes at step 20."""
    import contextlib
    import io
    from repro_torch.launch import train as launch
    from repro_torch.training import ft

    def args(steps, name):
        return launch.parse_args(list(DRILL_FLAGS) + [
            "--steps", str(steps), "--ckpt-dir", os.path.join(root, name),
            "--device", device])
    a = args(DRILL_STEPS, "whole")
    cfg = dataclasses.replace(launch.make_config(a), dtype=dtype)
    with contextlib.redirect_stdout(io.StringIO()):
        whole = launch.run(a, cfg, device)
        cut = launch.run(args(DRILL_STEPS, "cut"), cfg, device,
                         injector=ft.FailureInjector((DRILL_FAIL_AT,)))
        resumed = launch.run(args(DRILL_RESUME_STEPS, "whole"), cfg, device)
    restart_at = DRILL_FAIL_AT // 5 * 5
    tail = DRILL_STEPS - restart_at
    same_losses = cut["losses"][-tail:] == whole["losses"][-tail:]
    same_state = all(
        ka == kb and _same_bits(x, y) for (ka, x), (kb, y) in zip(
            _state_leaves(whole["result"]["state"]),
            _state_leaves(cut["result"]["state"])))
    line = dict(
        config=cfg.name, d_model=cfg.d_model, layers=cfg.n_layers,
        dtype=cfg.dtype,
        flags=list(DRILL_FLAGS), steps=DRILL_STEPS, fail_at=DRILL_FAIL_AT,
        restarts=cut["result"]["restarts"],
        losses_equal_from_step=restart_at, losses_equal=same_losses,
        final_state_equal_bits=same_state,
        loss_first_last=[whole["losses"][0], whole["losses"][-1]],
        resumed_steps=len(resumed["losses"]),
        resumed_counter=int(resumed["result"]["state"]["step"]))
    if cut["result"]["restarts"] != 1 or not same_losses or not same_state:
        fail(f"lm_train: the supervisor drill: {line}")
    if len(resumed["losses"]) != DRILL_RESUME_STEPS - DRILL_STEPS or \
            line["resumed_counter"] != DRILL_RESUME_STEPS:
        fail(f"lm_train: the rerun with {DRILL_RESUME_STEPS} steps did not "
             f"resume at step {DRILL_STEPS}: {line}")
    return line


def run_train_lm_example(root, device="cuda"):
    """``examples/torch_train_lm.py`` at its defaults (60 steps, a failure
    at step 25, the watchdog, then BCD through the batched engine)."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location("torch_train_lm",
                                                  TRAIN_LM_EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        out = ex.main(["--ckpt-dir", os.path.join(root, "example")],
                      device=device)
    line = dict(
        seconds=time.perf_counter() - t0, params=out["params"],
        restarts=out["restarts"], flagged_straggler_steps=out["flagged_steps"],
        loss_first=out["losses"][0],
        loss_last5_mean=float(np.mean(out["losses"][-5:])),
        kept=out["kept"], total=out["total"], token_acc=out["token_acc"],
        bcd_steps=len(out["result"].history),
        last_lines=printed.getvalue().splitlines()[-3:])
    if out["restarts"] != 1 or out["kept"] != out["total"] // 2 or \
            not np.isfinite(out["losses"]).all():
        fail(f"lm_train: the example: {line}")
    return line


def run_lm_train_path(by_path, device="cuda", cfg=None):
    """The LM training phase: StableLM-2-1.6B at its published widths in
    its own bfloat16 through ``launch.train.run`` (``LM_TRAIN_FLAGS``: 8
    steps, one checkpoint, restored and compared with the final state to
    the bit), the card-vs-CPU gradients of a 2-layer cut in float32 and in
    bfloat16, the checks from one state (:func:`lm_train_from_one_state`),
    a profiled step, the supervisor drill at ``--reduced`` width in the
    run's dtype and ``examples/torch_train_lm.py`` at its defaults; launch
    counts set to 0 just before the launcher's run and read after the
    example.  ``cfg``: another config for the full-width run, in its own
    dtype (a CPU rehearsal)."""
    import contextlib
    import io
    import shutil
    from repro_torch.convert import to_device
    from repro_torch.core import linearize, masks as M
    from repro_torch.data import MarkovTokens
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch
    from repro_torch.models.lm import LM
    from repro_torch.training import checkpoint, optimizer as opt_lib, train
    cuda = torch.device(device).type == "cuda"
    root = os.path.join(HERE, "build", "lm_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    laps = {}
    t_all = time.perf_counter()
    args = launch.parse_args(list(LM_TRAIN_FLAGS) + [
        "--ckpt-dir", os.path.join(root, "full"), "--device", device])
    # the config as published, in its own dtype (bfloat16); no width is
    # cut, the depth to LM_TRAIN_LAYERS
    full = dataclasses.replace(launch.make_config(args),
                               n_layers=LM_TRAIN_LAYERS) if cfg is None \
        else dataclasses.replace(cfg, remat_group=args.remat_group)
    try:
        build.reset_launch_counts()
        before = _reset_peak(device)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with checkpoint_costs(device) as ck, \
                contextlib.redirect_stdout(printed):
            got = launch.run(args, full, device)
        laps["launcher_run"] = time.perf_counter() - t0
        run_counts = counts()
        run_peak = _peak(device, before)
        losses, step_ms = got["losses"], got["step_ms"]
        if len(losses) != int(args.steps) or \
                not np.isfinite(losses).all():
            fail(f"lm_train: the launcher's losses: {losses}")
        saves = [c for c in ck.calls if c["op"] == "save"]
        if len(saves) != 1:
            fail(f"lm_train: {len(saves)} checkpoints written, not one")
        state = got["result"]["state"]
        n_params = sum(t.numel() for t in
                       opt_lib.tree_leaves(state["params"]))
        state_bytes = sum(t.numel() * t.element_size()
                          for _, t in _state_leaves(state))
        dtypes = sorted({str(t.dtype).replace("torch.", "")
                         for _, t in _state_leaves(state)})
        # the checkpoint of the last step, read back: the state's bits
        t0 = time.perf_counter()
        back, _ = checkpoint.restore(state, args.ckpt_dir, int(args.steps),
                                     device="cpu")
        round_trip = dict(
            seconds=time.perf_counter() - t0, equal_bits=all(
                ka == kb and _same_bits(a, b) for (ka, a), (kb, b) in zip(
                    _state_leaves(state), _state_leaves(back))))
        del back
        laps["checkpoint_round_trip"] = round_trip["seconds"]
        if not round_trip["equal_bits"]:
            fail("lm_train: the checkpoint read back differs from the "
                 "state it was written from")
        model = LM(full)
        mt = MarkovTokens(full.vocab, seed=0)
        masks = M.as_device(linearize.init_masks(model.mask_sites()),
                            device)

        def batch(i, n=int(args.global_batch)):
            return to_device(mt.batch(n, int(args.seq), i), device)

        t0 = time.perf_counter()
        grad = lm_train_grad_check(model, state["params"],
                                   batch(0, LM_TRAIN_GRAD_BATCH), device)
        laps["card_vs_cpu"] = time.perf_counter() - t0
        # the comparisons' schedule runs on past the launcher's 8 steps
        # (its cosine is 0 at step 8: no update to compare)
        opt = opt_lib.adamw(lr=args.lr, grad_clip=1.0,
                            schedule=opt_lib.cosine(args.lr,
                                                    2 * int(args.steps)))
        t0 = time.perf_counter()
        one = lm_train_from_one_state(model, state, batch(args.steps),
                                      masks, opt, device)
        laps["from_one_state"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = train.make_train_step(model, opt,
                                     train.TrainStepCfg(remat=True))
        prof = profile_lm_train_step(
            step, state, lambda i: batch(args.steps + 1 + i), masks,
            device) if cuda else None
        del state, got
        gc.collect()
        laps["profile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drill = run_supervisor_drill(root, device, full.dtype)
        laps["supervisor_drill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        example = run_train_lm_example(root, device)
        laps["example"] = time.perf_counter() - t0
        by_path["lm_train"] = counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(
        seconds=time.perf_counter() - t_all, seconds_by_part=laps,
        model=full.name, d_model=full.d_model, layers=full.n_layers,
        vocab=full.vocab, params=n_params, state_bytes=state_bytes,
        dtype=full.dtype, state_dtypes=dtypes, flags=list(LM_TRAIN_FLAGS),
        cuts=["random weights from seed 0, Markov tokens", "8 steps",
              f"{full.n_layers} of the config's layers"],
        losses=losses, step_ms=step_ms,
        step_ms_median_2_8=float(np.median(step_ms[1:])),
        run_launches={k: v for k, v in run_counts.items() if v},
        launches_per_step={k: v / len(losses) for k, v in
                           run_counts.items() if v},
        run_peak=run_peak, checkpoint=dict(
            bytes=saves[0]["bytes"], seconds=saves[0]["ms"] / 1e3,
            round_trip=round_trip),
        card_vs_cpu=grad, from_one_state=one, step_profile=prof,
        supervisor_drill=drill, example=example,
        last_lines=printed.getvalue().splitlines()[-2:])


class DiskWrites:
    """The bytes of every checkpoint this process writes
    (``checkpoint.save``: each step directory's files once written), by
    phase; and, where the system has them, the kernel's I/O counters of
    this process and the children it has reaped (``/proc/self/io``: the
    sweep's child processes write checkpoints this process does not
    see).  The card's machine allows 45 GiB of disk writes a run, counted
    even when deleted."""

    def __init__(self):
        self.phase, self.by_phase, self.saves = "setup", {}, 0

    def install(self) -> None:
        from repro_torch.training import checkpoint as ck
        save = ck.save

        def counted(*a, **kw):
            out = save(*a, **kw)
            n = sum(os.path.getsize(os.path.join(out, f))
                    for f in os.listdir(out))
            self.by_phase[self.phase] = self.by_phase.get(self.phase, 0) + n
            self.saves += 1
            return out
        ck.save = counted

    def summary(self) -> dict:
        try:
            with open("/proc/self/io") as f:
                io = {k: int(v) for k, v in
                      (line.split(":") for line in f if ":" in line)}
        except OSError:
            io = None
        return dict(checkpoint_bytes=sum(self.by_phase.values()),
                    checkpoint_bytes_by_phase=self.by_phase,
                    saves=self.saves, proc_self_io=io)


DISK = DiskWrites()


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
        if by_path[path]["rwkv6_scan_bwd:tf32x3"] != \
                by_path[path]["rwkv6_scan_bwd"]:
            fail(f"the {path} path ran "
                 f"{by_path[path]['rwkv6_scan_bwd:serial']} scan backwards "
                 "on route serial, not tf32x3")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    t_script = time.perf_counter()
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
    ap.add_argument("--only-lm", action="store_true",
                    help="build the kernels and run the StableLM-2-1.6B "
                         "path alone (float32, and BCD in bfloat16), "
                         "without the kernel comparison (prints no result "
                         "line)")
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
                         "(the three families' sweeps in float32 and in "
                         "bfloat16, with their card-vs-CPU gradient "
                         "checks), without the kernel comparison; with a "
                         "tag (rwkv, moe, hybrid), that family's sweeps "
                         "alone, with rwkv_bf16, moe_bf16 or hybrid_bf16 "
                         "its bfloat16 sweep alone (prints no result line)")
    ap.add_argument("--only-lm-train", action="store_true",
                    help="build the kernels and run the LM training phase "
                         "alone (StableLM-2-1.6B through launch.train at "
                         "full width, the supervisor drill, the train_lm "
                         "example), without the kernel comparison (prints "
                         "no result line)")
    ap.add_argument("--only-sharded", action="store_true",
                    help="build the kernels and run the candidate-parallel "
                         "phase alone (4 gloo ranks on the card), without "
                         "the kernel comparison (prints no result line)")
    ap.add_argument("--only-sharded-serve", action="store_true",
                    help="build the kernels and run the sharded serving "
                         "phase alone (4 gloo ranks on the card), without "
                         "the kernel comparison (prints no result line)")
    ap.add_argument("--only-sharded-train", action="store_true",
                    help="build the kernels and run the sharded training "
                         "phase alone (4 gloo ranks on the card), without "
                         "the kernel comparison (prints no result line)")
    ap.add_argument("--only-sharded-family", action="store_true",
                    help="build the kernels and run the sharded MoE and "
                         "hybrid phase alone (4 gloo ranks on the card), "
                         "without the kernel comparison (prints no result "
                         "line)")
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-phase", default=",".join(SHARDED_PHASES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-root", default=None, help=argparse.SUPPRESS)
    # a rehearsal of a rank on the CPU at reduced size
    ap.add_argument("--sharded-device", default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-small", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-world", type=int, default=SHARDED_WORLD,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--src", default=None,
                    help="with --only-lm, --only-rwkv, --only-moe or "
                         "--only-hybrid: "
                         "import repro_torch from this directory (another "
                         "checkout's src/), to compare two trees with the "
                         "same script")
    args = ap.parse_args()
    if args.sharded_rank is not None:
        if args.sharded_device == "cuda" and not torch.cuda.is_available():
            fail("no CUDA device: torch.cuda.is_available() is False")
        import repro_torch
        repro_torch.use_full_float32()
        run_rank_phase(args.sharded_phase, args.sharded_rank,
                       args.sharded_world, args.sharded_store,
                       args.sharded_out, args.sharded_root,
                       args.sharded_device, args.sharded_small)
        return
    alone = {"stablelm_1p6b": args.only_lm, "rwkv6_3b": args.only_rwkv,
             "deepseek_moe_16b": args.only_moe,
             "zamba2_2p7b": args.only_hybrid}
    if args.src:
        if not any(alone.values()):
            fail("--src is for --only-lm, --only-rwkv, --only-moe or "
                 "--only-hybrid")
        sys.path.insert(0, os.path.abspath(args.src))
        # the card's rates came from this checkout's package: the run
        # imports the other tree's
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]

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
    DISK.install()

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

    for spec in LM_PATHS + FAMILY_PATHS:
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
        DISK.phase = "resnet18_sweep"
        emit({"sweep": run_sweep_path(by_path)})
        check_launches(by_path, ("resnet18_sweep",))
        return
    switches = (args.only_sharded, args.only_sharded_serve,
                args.only_sharded_family, args.only_sharded_train)
    if any(switches):
        by_path = {}
        phases = tuple(p for p, on in zip(SHARDED_PHASES, switches) if on)
        for name, line in run_sharded_phases(by_path, phases).items():
            emit({name: line})
        check_launches(by_path, tuple(by_path))
        emit({"disk_writes": DISK.summary()})
        return
    if args.only_serve:
        by_path = {}
        emit({"serve": run_serve_path(by_path)})
        check_launches(by_path, ("serve", "serve_bf16"))
        return
    if args.only_lm_train:
        by_path = {}
        DISK.phase = "lm_train"
        emit({"lm_train": run_lm_train_path(by_path)})
        check_launches(by_path, ("lm_train",))
        emit({"disk_writes": DISK.summary()})
        return
    if args.only_family:
        by_path = {}
        DISK.phase = "family_sweep"
        run_family_path(by_path, only=None if args.only_family == "all"
                        else args.only_family)
        if args.only_family == "all":
            check_launches(by_path, ("family_sweep", "family_sweep_bf16"))
        emit({"family_launches": {
            path: {k: v for k, v in c.items() if v}
            for path, c in by_path.items()}})
        return
    t0 = time.perf_counter()
    cases = run_kernel_cases()
    emit({"kernel_cases": cases, "seconds": time.perf_counter() - t0})
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
    t0 = time.perf_counter()
    forward = run_forward(model, params, batch, SEED)
    forward["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    bcd_report = run_bcd_phase(model, params, batch, BCD_STEPS)
    bcd_report["seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
    sited = run_sited_phase(model, params, batch)
    sited["seconds"] = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    DISK.phase = "resnet18_sweep"
    sweep_line = run_sweep_path(by_path)
    sweep_line["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ---- path 1's candidate-parallel BCD, then sharded serving and
    # training, on one spawn of 4 ranks, each phase counted on its own
    DISK.phase = "sharded"
    sharded_lines = run_sharded_phases(by_path)

    # ---- paths 2 to 5, StableLM-2-1.6B, RWKV-6 3B, DeepSeek-MoE-16B and
    # Zamba2-2.7B
    for spec in LM_PATHS + FAMILY_PATHS:
        run_lm_path(spec, by_path)

    # ---- serving StableLM-2-1.6B and RWKV-6 3B, counted on its own
    t0 = time.perf_counter()
    serve_line = run_serve_path(by_path)
    serve_line["seconds"] = time.perf_counter() - t0

    # ---- training the LM families: the sweep of each, counted on its own
    DISK.phase = "family_sweep"
    run_family_path(by_path)

    # ---- training an LM through the launcher, counted on its own
    DISK.phase = "lm_train"
    emit({"lm_train": run_lm_train_path(by_path)})
    DISK.phase = "after"

    check_launches(by_path, PATH_KERNELS)
    launches = {k: sum(p[k] for p in by_path.values())
                for k in build.launch_counts}

    for name, line in zip(("train", "snl", "pipeline"), train_lines):
        emit({name: line})
    emit({"sweep": sweep_line})
    for name, line in sharded_lines.items():
        emit({name: line})
    emit({"serve": serve_line})
    emit({"disk_writes": DISK.summary()})
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
        family = [c for c in mine if "sharded_family" in c]
        if family:
            kernels[-1]["sharded_family_shapes"] = [
                {k: c.get(k) for k in (
                    "sharded_family", "shape", "max_abs_err", "ms",
                    "queued_ms", "plain_ms", "bound_ms", "bound_by")}
                for c in family]
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
        if name == "rwkv6_scan_bwd":
            kernels[-1].update(scan_bwd_routes(mine, by_path))
    emit({"script": {"seconds": time.perf_counter() - t_script}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
