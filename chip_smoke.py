#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, drives the port's main path —
masked-ReLU ResNet18 at full width, BCD candidate evaluation through
``bcd.run_bcd`` with the sequential, batched, pipelined and suffix engines —
and checks that the path went through the kernels (launch counts) and that
the four engines select identical blocks.

Output: one JSON object per line (``env``, ``build``, ``kernel_cases``,
``forward``, ``bcd``, ``sited``), then the card's name and power limit as
``nvidia-smi`` prints them, then the ``kernels`` summary, then the result
line.  Exits non-zero, without a result line, if there is no CUDA device, if
the build fails, if a kernel misses its tolerance, or if any phase raises.
There is no CPU path here.

Tolerances (stated again in the output):
  * gate, float32: |err| <= 1e-6 + 1e-6*|ref| — same arithmetic, rounded the
    same way; only tanhf/expf may differ from PyTorch's by an ulp.
  * gate and fused conv, bfloat16: |err| <= 1e-2 + 1e-2*|ref| against the
    plain version computed in float32 from the same bfloat16 inputs and
    rounded once — one bfloat16 ulp is 2^-8 relative.
  * fused conv, float32: |err| <= 2e-4 + 2e-4*|ref| — up to 9*512 products
    are summed in another order than cuDNN's full-float32 algorithms
    (TF32 is off), some of which (Winograd, FFT) round more than a direct
    sum; the error of both against a float64 convolution is printed too.
  * logits: 2e-3 absolute between fused/unfused and stacked/un-stacked
    forwards, and between the card and the CPU — BatchNorm's rsqrt amplifies
    conv rounding through 17 gated layers.

Times are CUDA-event times over repeated launches after a warm-up, at the
shapes the main path uses, without flushing the L2 cache between launches
(the big shapes exceed it).  ``bound_ms`` is the larger of bytes/3.35 TB/s
(each input read once, each output written once) and operations/67 TFLOP/s
(float32 outside the tensor cores, which is what these kernels use).
"""
from __future__ import annotations

import argparse
import json
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

SOURCE = "src/repro_torch/kernels/csrc/masked_act.cu"
REPLACES = {
    "masked_act_2d": "src/repro/kernels/masked_act.py:55",
    "masked_act_2d_batched": "src/repro/kernels/masked_act.py:140",
    "masked_act_conv3x3": "src/repro/kernels/masked_act.py:393",
    "masked_act_conv3x3_batched": "src/repro/kernels/masked_act.py:424",
}
TOL = {
    ("gate", torch.float32): (1e-6, 1e-6),
    ("gate", torch.bfloat16): (1e-2, 1e-2),
    ("conv", torch.float32): (2e-4, 2e-4),
    ("conv", torch.bfloat16): (1e-2, 1e-2),
}
LOGIT_TOL = 2e-3
SEED = 0            # weights, data and masks
BCD_STEPS = 3       # outer steps per engine (b_target 300 below the start)


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


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory and spills per ``__global__`` template, from
    what ``nvcc -Xptxas -v`` printed (ranges over the instantiations)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = "gate_conv3x3_kernel" if "gate_conv3x3" in ln else \
                "gate_kernel" if "gate_kernel" in ln else "other"
            out.setdefault(name, {"instantiations": 0, "registers": [],
                                  "smem_bytes": [], "spill_bytes": 0})
            out[name]["instantiations"] += 1
        elif name and "bytes spill stores" in ln:
            nums = [int(t) for t in ln.replace(",", " ").split()
                    if t.isdigit()]
            out[name]["spill_bytes"] += sum(nums[1:3])
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


def conv_case(name, dtype, kind, n, b, h, w_, cin, cout, stride, shared_x,
              primary, seed, timed=False):
    """One comparison of the fused gate→conv kernel with the unfused pair."""
    from repro_torch.kernels import masked_act as K, ref
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

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    byts = nbytes(x, mask, wt) + out.numel() * out.element_size()
    cands = n if batched else 1
    flops = 2.0 * cands * b * valid_taps(h, stride) * \
        valid_taps(w_, stride) * cin * cout
    extra = dict(kind=kind, shape=list(x.shape), cout=cout, stride=stride,
                 shared_x=shared_x)
    if dtype == torch.float32 and primary:
        exact = ref.masked_act_conv3x3_ref(
            x.double(), mask.double(), wt.double(), stride=stride, kind=kind)
        extra["kernel_err_vs_f64"] = float((out.double() - exact).abs().max())
        extra["plain_err_vs_f64"] = float((want.double() - exact).abs().max())
        del exact
    # library yardstick: the gate, then the one library call (F.conv2d) that
    # computes the product — which is what the plain version is
    return finish_case(name, "conv", dtype, out, want, kernel, plain,
                       True, byts, flops, primary, extra, timed)


def finish_case(name, family, dtype, out, want, kernel, plain,
                plain_is_library, byts, flops, primary, extra, timed=False):
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
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        plain_ms = time_ms(plain)
        case.update(
            ms=time_ms(kernel), plain_ms=plain_ms,
            library_ms=plain_ms if plain_is_library else None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=byts, flops=flops)
    del out, want
    torch.cuda.empty_cache()
    return case


def run_kernel_cases():
    """Every kernel at the shapes the main path gives it (eval batch 128,
    chunks of 8 candidates, the four ResNet18 stages) and at ragged small
    shapes in all four kinds, float32 and bfloat16, with and without a
    shared (stride-0) activation.  ``primary`` marks the case whose times go
    into the ``kernels`` line; ``timed`` cases are timed as well."""
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = ("relu", "gelu", "silu", "sqrelu")
    stages = ((32, 64), (16, 128), (8, 256), (4, 512))      # (H = W, C)
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
    for i, kind in enumerate(kinds):
        cases.append(gate_case(g2b, f32, kind, n=3, rows=5, cols=77,
                               poly=i % 2 == 1, shared_x=i % 2 == 0,
                               primary=False, seed=30 + i))
        cases.append(gate_case(g2b, bf16, kind, n=3, rows=9, cols=264,
                               poly=i % 2 == 0, shared_x=i % 2 == 1,
                               primary=False, seed=40 + i))

    # ---- masked_act_conv3x3: un-stacked fused forward, relu1 -> conv2
    c3 = "masked_act_conv3x3"
    for i, (hw, c) in enumerate((stages[0], stages[3])):
        cases.append(conv_case(c3, f32, "relu", n=1, b=128, h=hw, w_=hw,
                               cin=c, cout=c, stride=1, shared_x=False,
                               primary=i == 0, seed=6 + i))
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

    # ---- masked_act_conv3x3_batched: the suffix engine's fused forwards
    c3b = "masked_act_conv3x3_batched"
    for i, (hw, c) in enumerate(stages):
        cases.append(conv_case(c3b, f32, "relu", n=8, b=128, h=hw, w_=hw,
                               cin=c, cout=c, stride=1, shared_x=False,
                               primary=i == 0, seed=70 + i, timed=True))
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
    from repro_torch.kernels import masked_act as K
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
            before = dict(K.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bcd.run_bcd(masks0, cfg, eval_acc, evaluator=evaluator)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: K.launch_counts[k] - before[k]
                        for k in K.launch_counts}
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
    from repro_torch.kernels import masked_act as K
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
            before = dict(K.launch_counts)
            accs[label] = np.concatenate([ev.evaluate(it) for it in items])
            launches = {k: K.launch_counts[k] - before[k]
                        for k in K.launch_counts}
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="build and compare the kernels, then stop "
                         "(prints no result line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")

    import repro_torch
    from repro_torch.kernels import build, masked_act as K
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
    build.load()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "library": str(build.build()),
                    "ptxas": ptxas_summary(build.build_log())}})

    cases = run_kernel_cases()
    emit({"kernel_cases": cases})
    if args.only_kernels:
        return

    model, params, batch = make_model_and_batch(SEED)
    # ---- the main path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    forward = run_forward(model, params, batch, SEED)
    bcd_report = run_bcd_phase(model, params, batch, BCD_STEPS)
    sited = run_sited_phase(model, params, batch)
    launches = dict(K.launch_counts)
    emit({"forward": forward})
    emit({"bcd": bcd_report})
    emit({"sited": sited})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path launched these kernels no time: {missing}")

    kernels = []
    for name in K.launch_counts:
        mine = [c for c in cases if c["name"] == name]
        prim = next(c for c in mine if c["primary"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine
                               if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c["max_abs_err"] for c in mine
                                    if c["dtype"] == "bfloat16"),
            "ms": prim["ms"], "plain_ms": prim["plain_ms"],
            "bound_ms": prim["bound_ms"], "bound_by": prim["bound_by"],
            "library_ms": prim["library_ms"],
            "shape": prim["shape"], "dtype": prim["dtype"],
            "tolerance": {"atol": prim["atol"], "rtol": prim["rtol"]}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
