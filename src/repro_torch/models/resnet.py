"""The paper's backbones: CIFAR-style ResNet18 and WideResNet-22-8.

Counterpart of ``repro/models/resnet.py``.  Every ReLU is a mask site with
the *full per-pixel activation shape* (H, W, C), shared across the batch —
the paper's mask granularity (ResNet18 @32×32: 557,056 ReLUs).

BatchNorm uses batch statistics in both train and eval, biased variance,
eps 1e-5.

Layouts are the reference's: activations NHWC, conv weights HWIO, parameters
a plain nested dict of tensors with the reference's keys.

**The candidate axis is explicit.**  Every function takes one mask tree
(leaves ``(H, W, C)``) or N stacked candidates (leaves ``(N, H, W, C)``).
Activations are ``(B, ...)`` while all candidates still share them and
become ``(N, B, ...)`` at the first stacked gate; plain convolutions run on
the ``(N·B, ...)`` view, and BatchNorm reduces over ``(B, H, W)`` *per
candidate* (reducing over the folded view would mix candidates).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.core import linearize, masks as M
from repro_torch.convert import to_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import conv_same_nhwc


def _conv(x, w, stride=1):
    """SAME conv over NHWC with any leading dims: (B, H, W, C) or stacked
    (N, B, H, W, C), folded to (N·B, H, W, C) for ``F.conv2d``."""
    lead = x.shape[:-3]
    y = conv_same_nhwc(x.reshape((-1,) + tuple(x.shape[-3:])), w, stride)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def _conv_init(gen, kh, kw, cin, cout, device):
    fan = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (2.0 / fan) ** 0.5).to(device)


def _bn_init(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn(p, x, eps=1e-5):
    # (B, H, W) are dims -4..-2 with or without a leading candidate axis:
    # statistics are per candidate
    var, mean = torch.var_mean(x, dim=(-4, -3, -2), unbiased=False,
                               keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def accuracy(logits, labels):
    """Top-1 accuracy in percent: a 0-d tensor for (B, classes) logits, an
    (N,) tensor for stacked (N, B, classes) logits.  Stays on the device."""
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    return hit.mean(-1) * 100.0


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    n_classes: int
    image_size: int
    # (channels, n_blocks, stride) per stage
    stages: Tuple[Tuple[int, int, int], ...]
    stem_channels: int
    wide: bool = False          # WRN pre-activation blocks

    @staticmethod
    def resnet18(n_classes=10, image_size=32):
        return CNNConfig("resnet18", n_classes, image_size,
                         ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)),
                         stem_channels=64)

    @staticmethod
    def wrn22_8(n_classes=10, image_size=32):
        return CNNConfig("wrn22_8", n_classes, image_size,
                         ((128, 3, 1), (256, 3, 2), (512, 3, 2)),
                         stem_channels=16, wide=True)


class CNN:
    """Masked-ReLU CNN: plain functions over a parameter dict.

    Building one turns TF32 off process-wide
    (:func:`repro_torch.use_full_float32`): the fused kernels accumulate in
    exact float32 and every evaluation path must rank candidates alike.
    """

    def __init__(self, cfg: CNNConfig):
        repro_torch.use_full_float32()
        self.cfg = cfg
        self._site_shapes = self._compute_site_shapes()
        self._segs = self._build_segments()
        self._seg_of_site = {s: i for i, (_, sites, _) in
                             enumerate(self._segs) for s in sites}

    # ---------------------------------------------------------- structure

    def _block_plan(self):
        """Yields (stage, block, cin, cout, stride, hw) tuples."""
        cfg = self.cfg
        hw = cfg.image_size
        cin = cfg.stem_channels
        for si, (cout, n, stride) in enumerate(cfg.stages):
            for bi in range(n):
                s = stride if bi == 0 else 1
                hw_out = hw // s
                yield si, bi, cin, cout, s, hw_out
                cin, hw = cout, hw_out

    def _compute_site_shapes(self):
        cfg = self.cfg
        shapes: Dict[str, Tuple[int, ...]] = {}
        if not cfg.wide:
            shapes["stem.relu"] = (cfg.image_size, cfg.image_size,
                                   cfg.stem_channels)
        for si, bi, cin, cout, s, hw in self._block_plan():
            if cfg.wide:
                hw_in = hw * s
                shapes[f"g{si}b{bi}.relu1"] = (hw_in, hw_in, cin)
                shapes[f"g{si}b{bi}.relu2"] = (hw, hw, cout)
            else:
                shapes[f"g{si}b{bi}.relu1"] = (hw, hw, cout)
                shapes[f"g{si}b{bi}.relu2"] = (hw, hw, cout)
        if cfg.wide:
            hw_f = cfg.image_size // 4
            shapes["final.relu"] = (hw_f, hw_f, cfg.stages[-1][0])
        return shapes

    def mask_sites(self) -> Dict[str, linearize.MaskSite]:
        return {k: linearize.MaskSite(v, "relu")
                for k, v in self._site_shapes.items()}

    def relu_count(self) -> int:
        return sum(int(np.prod(s)) for s in self._site_shapes.values())

    # ---------------------------------------------------------- params

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters (He-normal convs, unit BatchNorm), drawn from
        an explicit generator and placed on ``device``.  Same tree and keys
        as the reference's ``CNN.init``; not the same numbers — tests that
        compare the two packages convert the reference's parameters
        (``repro_torch.convert``) instead of re-initialising."""
        cfg = self.cfg
        g = generator
        p = {"stem": {"conv": _conv_init(g, 3, 3, 3, cfg.stem_channels,
                                         device),
                      "bn": _bn_init(cfg.stem_channels, device)}}
        for si, bi, cin, cout, s, hw in self._block_plan():
            blk = {"conv1": _conv_init(g, 3, 3, cin, cout, device),
                   "bn1": _bn_init(cin if cfg.wide else cout, device),
                   "conv2": _conv_init(g, 3, 3, cout, cout, device),
                   "bn2": _bn_init(cout, device)}
            if s != 1 or cin != cout:
                blk["proj"] = _conv_init(g, 1, 1, cin, cout, device)
            p[f"g{si}b{bi}"] = blk
        cfinal = cfg.stages[-1][0]
        if cfg.wide:
            p["final_bn"] = _bn_init(cfinal, device)
        w = torch.randn((cfinal, cfg.n_classes), generator=g,
                        device=g.device, dtype=torch.float32)
        p["fc"] = {"w": (w * cfinal ** -0.5).to(device),
                   "b": torch.zeros((cfg.n_classes,), device=device)}
        return p

    # ---------------------------------------------------------- forward
    #
    # The forward is a fold over an ordered *segment* list.  Each segment is
    # (name, sites_it_applies, fn(params, masks, x, opt) -> x); the full
    # forward, forward_prefix, and forward_suffix all fold the same list, so
    # the split-forward contract
    #     forward_suffix(p, m, forward_prefix(p, m, x, site), site)
    #         == forward(p, m, x)
    # holds *by construction* — prefix/suffix run exactly the operations
    # forward runs (core.engine.SuffixEvaluator relies on it).  ``opt`` is
    # the per-call option tuple (poly, soft, fused, ties).

    def _relu(self, x, masks, name, opt):
        poly, soft, _, ties = opt
        site = linearize.MaskSite(self._site_shapes[name], "relu")
        return linearize.apply_masked_act(
            x, masks[name], site,
            poly=None if poly is None else poly.get(name), soft=soft,
            ties=ties)

    def _relu_conv(self, x, masks, name, opt, w, stride=1):
        """Masked ReLU at ``name`` feeding a 3x3 conv.  With ``fused`` a
        hard-mask site runs gate + conv as one kernel
        (``kernels.ops.masked_act_conv3x3[_batched]``) — the gated tensor is
        never written to device memory.  Soft relaxation, poly2 replacement
        and chunks that carry share ties keep the plain unfused pair."""
        poly, soft, fused, ties = opt
        p = None if poly is None else poly.get(name)
        if fused and not soft and p is None and not ties:
            m = masks[name]
            if m.dim() == 4:
                return ops.masked_act_conv3x3_batched(x, m, w, stride=stride,
                                                      kind="relu")
            if x.dim() == 4:
                return ops.masked_act_conv3x3(x, m, w, stride=stride,
                                              kind="relu")
            # per-candidate activations under one shared mask
            y = ops.masked_act_conv3x3(x.reshape((-1,) + tuple(x.shape[2:])),
                                       m, w, stride=stride, kind="relu")
            return y.reshape(tuple(x.shape[:2]) + tuple(y.shape[1:]))
        return _conv(self._relu(x, masks, name, opt), w, stride)

    def _stem_pre(self, p, x):
        """Mask-independent stem fold: input -> the first gate's
        pre-activation (conv [+ bn]).  Depends only on (params, images), so
        evaluator backends compute it ONCE per context (``forward_pre``)
        and every candidate's full forward starts from the cached result
        (``forward(..., pre=...)``)."""
        if self.cfg.wide:
            return _conv(x, p["stem"]["conv"])
        return _bn(p["stem"]["bn"], _conv(x, p["stem"]["conv"]))

    def _stem_gate(self, p, m, x, opt):
        """The mask-dependent remainder of the stem segment (no-op for the
        wide config, whose first gate lives in g0b0)."""
        if self.cfg.wide:
            return x
        return self._relu(x, m, "stem.relu", opt)

    def _build_segments(self):
        cfg = self.cfg
        segs = []
        segs.append(("stem", () if cfg.wide else ("stem.relu",),
                     lambda p, m, x, opt:
                     self._stem_gate(p, m, self._stem_pre(p, x), opt)))
        for si, bi, cin, cout, s, hw in self._block_plan():
            name = f"g{si}b{bi}"
            if cfg.wide:
                def blk_fn(p, m, x, opt, name=name, s=s):
                    blk = p[name]
                    # relu1's output feeds both conv1 and the projection
                    # shortcut, so only relu2 -> conv2 (single consumer)
                    # is fusable
                    h = self._relu(_bn(blk["bn1"], x), m,
                                   f"{name}.relu1", opt)
                    y = _conv(h, blk["conv1"], s)
                    y = self._relu_conv(_bn(blk["bn2"], y), m,
                                        f"{name}.relu2", opt, blk["conv2"])
                    sc = _conv(h, blk["proj"], s) if "proj" in blk else x
                    return y + sc
            else:
                def blk_fn(p, m, x, opt, name=name, s=s):
                    blk = p[name]
                    y = self._relu_conv(_bn(blk["bn1"], _conv(x, blk["conv1"],
                                                              s)),
                                        m, f"{name}.relu1", opt,
                                        blk["conv2"])
                    y = _bn(blk["bn2"], y)
                    sc = _conv(x, blk["proj"], s) if "proj" in blk else x
                    return self._relu(y + sc, m, f"{name}.relu2", opt)
            segs.append((name, (f"{name}.relu1", f"{name}.relu2"), blk_fn))

        def head_fn(p, m, x, opt):
            if cfg.wide:
                x = self._relu(_bn(p["final_bn"], x), m, "final.relu", opt)
            x = x.mean(dim=(-3, -2))
            return x @ p["fc"]["w"] + p["fc"]["b"]
        segs.append(("head", ("final.relu",) if cfg.wide else (), head_fn))
        return segs

    def forward(self, params, masks, images, *, poly=None, soft=False,
                pre=None, fused=False, ties=True):
        """Full forward to logits: (B, classes), or (N, B, classes) for
        stacked masks.

        ``pre``: a cached :meth:`forward_pre` result — the fold resumes at
        the first gate and ``images`` is ignored.  ``fused``: fold every
        ``relu → 3x3 conv`` pair into one kernel.  ``ties=False`` promises
        that no mask coordinate is share-tied (decided on the host from the
        numpy tree, see ``linearize.has_share_ties``) and skips the tie
        override's extra passes."""
        opt = (poly, soft, fused, ties)
        if pre is not None:
            x = self._stem_gate(params, masks, pre, opt)
            segs = self._segs[1:]
        else:
            x = images
            segs = self._segs
        for _, _, fn in segs:
            x = fn(params, masks, x, opt)
        return x

    def forward_pre(self, params, images):
        """Mask-independent head of the network (input -> first gate's
        pre-activation).  Computed once per evaluator context and fed back
        through ``forward(..., pre=...)`` — the "depth-0 prefix" every
        candidate shares regardless of which masks it mutates."""
        return self._stem_pre(params, images)

    # ------------------------------------------------------- split forward
    #
    # BCD candidates are local mask edits: a candidate whose earliest
    # touched site sits in segment k shares everything before segment k with
    # the base masks.  forward_prefix computes that shared part once;
    # forward_suffix finishes the net from the cached activation.

    def site_order(self) -> Tuple[str, ...]:
        """All mask sites in forward (topological) order."""
        return tuple(s for _, sites, _ in self._segs for s in sites)

    def site_segments(self) -> Dict[str, int]:
        """site name -> index of the segment that applies it.  Sites that
        share a segment share a prefix."""
        return dict(self._seg_of_site)

    def suffix_sites(self, site: str) -> Tuple[str, ...]:
        """The sites forward_suffix(site) consumes: every site applied by
        the cut segment or later (the candidate mask values the suffix
        evaluator must ship per candidate)."""
        cut = self._seg_of_site[site]
        return tuple(s for _, sites, _ in self._segs[cut:] for s in sites)

    def forward_prefix(self, params, masks, images, site, *, poly=None,
                       soft=False, from_site=None, cached=None, fused=False,
                       ties=True):
        """Run forward up to (excluding) the segment that applies ``site``;
        returns the cached boundary activation (the suffix's input).

        Multi-depth entry: ``from_site``/``cached`` resume from an earlier
        prefix instead of the input — folding only the segments in
        ``[seg(from_site), seg(site))``, so
        ``forward_prefix(..., site=b, from_site=a, cached=prefix(a))``
        computes exactly ``forward_prefix(..., site=b)`` (the prefix-trie
        extension contract)."""
        opt = (poly, soft, fused, ties)
        lo = 0
        x = images
        if from_site is not None:
            lo = self._seg_of_site[from_site]
            x = cached
        for _, _, fn in self._segs[lo:self._seg_of_site[site]]:
            x = fn(params, masks, x, opt)
        return x

    def forward_suffix(self, params, masks, cached, site, *, poly=None,
                       soft=False, fused=False, ties=True):
        """Finish forward from a :meth:`forward_prefix` cache: folds the
        segment applying ``site`` and everything after it to logits.  With
        stacked masks the shared ``cached`` activation is read by every
        candidate and never broadcast in memory."""
        opt = (poly, soft, fused, ties)
        x = cached
        for _, _, fn in self._segs[self._seg_of_site[site]:]:
            x = fn(params, masks, x, opt)
        return x

    def _segment_flops(self) -> List[float]:
        """Per-sample forward FLOPs per segment (conv + fc terms only —
        the >99% of the work; used by the suffix cost model)."""
        cfg = self.cfg
        flops = [0.0] * len(self._segs)
        seg_idx = {name: i for i, (name, _, _) in enumerate(self._segs)}
        flops[seg_idx["stem"]] = (
            2.0 * 9 * 3 * cfg.stem_channels * cfg.image_size ** 2)
        for si, bi, cin, cout, s, hw in self._block_plan():
            f = 2.0 * 9 * cin * cout * hw ** 2          # conv1 (stride s)
            f += 2.0 * 9 * cout * cout * hw ** 2        # conv2
            if s != 1 or cin != cout:
                f += 2.0 * cin * cout * hw ** 2         # 1x1 proj
            flops[seg_idx[f"g{si}b{bi}"]] += f
        flops[seg_idx["head"]] = 2.0 * cfg.stages[-1][0] * cfg.n_classes
        return flops

    def site_prefix_fractions(self) -> Dict[str, float]:
        """site -> fraction of full-forward FLOPs strictly before its
        segment.  0.0 for first-segment sites (suffix mode buys nothing),
        approaching 1.0 for the deepest sites — the suffix cost model
        (analysis.roofline.SuffixCostModel) thresholds on this."""
        seg_flops = self._segment_flops()
        total = max(sum(seg_flops), 1.0)
        cum = 0.0
        before = []
        for f in seg_flops:
            before.append(cum / total)
            cum += f
        return {s: before[i] for s, i in self._seg_of_site.items()}

    # ------------------------------------------------------- eval closures
    #
    # BCD's candidate-evaluation engine (core.engine) needs two views of
    # "accuracy under a mask tree": a device closure that takes one tree or
    # a stack of N (the batched/pipelined backends hand it the whole chunk),
    # and a plain host callable for the sequential reference / per-step
    # base accuracies.  Device closures return tensors and never
    # synchronise; the evaluator decides when to read.

    def make_param_eval_fn(self, batch, device="cuda"):
        """``(mask_tree, params, ties=True) -> accuracy[%]`` on ``device``
        — for evaluator backends whose params change between BCD outer
        steps (finetuning): params ride as evaluator context.  Stacked
        masks give an (N,) tensor."""
        images = to_device(batch["images"], device)
        labels = to_device(batch["labels"], device)

        def eval_fn(masks, params, ties=True):
            logits = self.forward(params, masks, images, ties=ties)
            return accuracy(logits, labels)
        return eval_fn

    def make_eval_fn(self, params, batch, device="cuda"):
        """``mask_tree -> accuracy[%]`` closure over a fixed
        (params, batch)."""
        fn = self.make_param_eval_fn(batch, device)
        return lambda masks, ties=True: fn(masks, params, ties=ties)

    def make_joint_eval_fn(self):
        """``(mask_tree, ctx, ties=True) -> accuracy[%]`` with
        ``ctx = {"params": ..., "batch": ...}`` — params AND the eval batch
        ride as evaluator context.  ``ctx["pre"]`` (optional) is the
        mask-independent stem fold, computed once per context by the
        evaluator (SplitEval.pre)."""
        def eval_fn(masks, ctx, ties=True):
            batch = ctx["batch"]
            logits = self.forward(ctx["params"], masks, batch["images"],
                                  pre=ctx.get("pre"), ties=ties)
            return accuracy(logits, batch["labels"])
        return eval_fn

    def make_suffix_eval_fns(self):
        """Split-forward closure bundle for ``engine.SuffixEvaluator``.

        ``prefix(site, masks, ctx) -> cached`` runs the shared part of the
        net once per (site, step); ``suffix(site, masks, cached, ctx) ->
        acc[%]`` takes the stacked suffix-site masks of a chunk —
        per-candidate work shrinks to the layers at/after the mutated site.
        ``ctx = {"params", "batch"}`` rides as evaluator context exactly
        like :meth:`make_joint_eval_fn`.
        """
        from repro_torch.core import engine

        def prefix_fn(site, masks, ctx, ties=True):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["images"], site,
                                       ties=ties)

        def prefix_ext_fn(from_site, site, masks, cached, ctx, ties=True):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["images"], site,
                                       from_site=from_site, cached=cached,
                                       ties=ties)

        def suffix_fn(site, masks, cached, ctx, fused=False, ties=True):
            logits = self.forward_suffix(ctx["params"], masks, cached, site,
                                         fused=fused, ties=ties)
            return accuracy(logits, ctx["batch"]["labels"])

        def pre_fn(ctx):
            return self.forward_pre(ctx["params"], ctx["batch"]["images"])

        return engine.SplitEval(
            prefix=prefix_fn, suffix=suffix_fn,
            full=self.make_joint_eval_fn(),
            site_order=self.site_order(),
            site_segment=self.site_segments(),
            suffix_sites=self.suffix_sites,
            prefix_fraction=self.site_prefix_fractions(),
            prefix_ext=prefix_ext_fn,
            pre=pre_fn)

    def make_eval_acc(self, params, batch, device="cuda"):
        """Host callable ``mask_tree -> float`` (single-candidate path) —
        what ``run_bcd``'s eval_acc argument expects.  Reads the result
        back, so it synchronises once per call."""
        fn = self.make_eval_fn(params, batch, device)

        def eval_acc(masks):
            ties = linearize.has_share_ties(masks)
            return float(fn(M.as_device(masks, device), ties=ties))
        return eval_acc

