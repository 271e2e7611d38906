"""Unified LM backbone for every block kind: eval, prefill and decode.

Counterpart of ``repro/models/lm.py``.  A model is ``head_blocks`` + a stack
of ``n_repeats`` copies of ``cfg.pattern`` + a ``tail`` (the pattern
remainder).  Parameters keep the reference's tree: ``params["stack"][pos]``
leaves carry a leading repeat axis ``(R, ...)``, so a converted reference
tree (``repro_torch.convert.params_from_reference``) maps one to one.  The
reference's ``lax.scan`` over repeats is a Python loop here; its
compilation fences have no counterpart in eager PyTorch.  A ``shared``
pattern block (Zamba2's attention) keeps one parameter set with no repeat
axis, read by every repeat; its caches do have the repeat axis.

Block kinds and their mask sites (the elementwise nonlinearities):
``dense`` (attention + FFN: the FFN activation, suffix ``ffn``, (d_ff,)),
``moe`` (attention + MoE: the routed experts' gate ``moe``, (E, F), and
the shared expert's ``moe_shared``, (d_ff_shared,), where the config has
one), ``mamba`` (Mamba2: the silu gate on z, ``mamba``, (d_inner,)),
``rwkv`` (RWKV-6: the channel-mix ``sqrelu``, ``rwkv``, (d_ff,)) and
``attn_only`` (attention alone, no site).  Head and tail sites are named
``h<i>.<suf>`` and ``t<i>.<suf>``; a stack site ``s<pos>.<suf>`` carries a
leading repeat axis, ``(R, *shape)``.

**The candidate axis is explicit.**  A mask tree is one candidate (leaves
of the site shapes) or N stacked ones (leaves ``(N, ...)``).  The activation
stays ``(B, S, D)`` while the candidates share it and becomes
``(N, B, S, D)`` at the first stacked gate: attention and the gate and up
projections of the first layer after a cached prefix run once, not N times,
and attention and the RWKV time-mix scan fold ``N·B`` into their batch after
that.  A MoE block routes per row of that explicit axis
(``models.moe``).  Under ``fused=`` dense FFNs and MoE shared experts take
the fused gate→matmul kernels; routed experts, Mamba2 and RWKV blocks stay
on the gate route, as the reference routes them.

**Serving** (``forward(cache=, cache_len=)``, :meth:`LM.init_cache`):
``dense``, ``moe`` and ``attn_only`` blocks keep a KV cache, a Mamba2
block its scan state and its convolution's trailing inputs, an RWKV-6
block its scan state and the two token shifts' last inputs, in the
reference's cache tree.  The port writes the cache **in place** where the
reference returns a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.configs.base import ArchConfig, Block
from repro_torch.convert import to_device
from repro_torch.core import linearize, masks as M
from . import layers, moe as moe_lib, ssm


def _attn_cfg(cfg: ArchConfig, blk: Block) -> layers.AttnCfg:
    return layers.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, window=blk.window,
        rope_theta=blk.rope_theta)


def _moe_cfg(cfg: ArchConfig) -> moe_lib.MoECfg:
    return moe_lib.MoECfg(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert,
        n_shared=1 if cfg.n_shared_experts else 0,
        d_ff_shared=cfg.d_ff_shared, capacity_factor=cfg.capacity_factor,
        dispatch=cfg.moe_dispatch)


def _mamba_cfg(cfg: ArchConfig) -> ssm.MambaCfg:
    di = cfg.d_inner
    return ssm.MambaCfg(d_model=cfg.d_model, d_inner=di,
                        n_heads=di // cfg.mamba_head_dim,
                        head_dim=cfg.mamba_head_dim, d_state=cfg.ssm_state)


def _rwkv_cfg(cfg: ArchConfig) -> ssm.RWKVCfg:
    return ssm.RWKVCfg(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       head_dim=cfg.rwkv_head_dim)


def _sites_for(cfg: ArchConfig, blk: Block) -> Dict[str, linearize.MaskSite]:
    rep = cfg.act_when_masked
    if blk.kind == "dense":
        return {"ffn": linearize.MaskSite((cfg.d_ff,), cfg.act, rep)}
    if blk.kind == "moe":
        out = {"moe": linearize.MaskSite(
            (cfg.n_experts, cfg.d_ff_expert), cfg.act, rep)}
        if cfg.n_shared_experts:
            out["moe_shared"] = linearize.MaskSite(
                (cfg.d_ff_shared,), cfg.act, rep)
        return out
    if blk.kind == "mamba":
        return {"mamba": linearize.MaskSite((cfg.d_inner,), "silu", rep)}
    if blk.kind == "rwkv":
        return {"rwkv": linearize.MaskSite((cfg.d_ff,), "sqrelu", rep)}
    if blk.kind == "attn_only":
        return {}
    raise ValueError(f"unknown block kind {blk.kind!r} (dense, moe, mamba, "
                     "rwkv or attn_only)")


def token_accuracy(logits, labels):
    """Next-token accuracy in percent: a 0-d tensor for (B, S, V) logits, an
    (N,) tensor for stacked (N, B, S, V) ones.  The hit count is divided by
    the position count once, as the reference's mean is, so the value is
    the same float32 number.  Stays on the device."""
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    return hit.sum(dim=(-2, -1)) / float(labels.numel()) * 100.0


class LM:
    """The LM of every block kind: plain functions over a parameter tree.

    Building one turns TF32 off process-wide
    (:func:`repro_torch.use_full_float32`): the fused kernels accumulate in
    exact float32, and every evaluation path must rank candidates alike."""

    def __init__(self, cfg: ArchConfig):
        blocks = tuple(cfg.head_blocks) + tuple(cfg.pattern) + tuple(cfg.tail)
        for blk in blocks:
            _sites_for(cfg, blk)          # raises for an unknown kind
        repro_torch.use_full_float32()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32

    # ------------------------------------------------------------ init

    def _layer_init(self, gen, blk: Block, device):
        """One block's parameters, in the reference's tree, drawn from
        ``gen`` in the order of the tree's keys."""
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        if blk.kind == "rwkv":
            return {"ln1": layers.rmsnorm_init(d, device),
                    "ln2": layers.rmsnorm_init(d, device),
                    "tmix": ssm.rwkv_init(gen, _rwkv_cfg(cfg), dt, device)}
        if blk.kind == "mamba":
            return {"ln": layers.rmsnorm_init(d, device),
                    "mamba": ssm.mamba_init(gen, _mamba_cfg(cfg), dt,
                                            device)}
        p = {"ln1": layers.rmsnorm_init(d, device),
             "attn": layers.attn_init(gen, _attn_cfg(cfg, blk), dt, device)}
        if blk.kind == "dense":
            p["ln2"] = layers.rmsnorm_init(d, device)
            p["ffn"] = layers.ffn_init(gen, d, cfg.d_ff, gated=cfg.gated_ffn,
                                       dtype=dt, device=device)
        elif blk.kind == "moe":
            p["ln2"] = layers.rmsnorm_init(d, device)
            p["moe"] = moe_lib.moe_init(gen, _moe_cfg(cfg), dt, device)
        return p

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from an explicit generator and placed on
        ``device`` (the draws happen on the generator's device).  Same tree,
        keys, shapes and dtypes as the reference's ``LM.init``; not the same
        numbers — tests that compare the two packages convert the
        reference's parameters instead of re-initialising.

        Draw order: the embedding, the head blocks, the tail blocks, then
        the stack position by position — a shared block once, any other
        block repeat by repeat, each repeat's leaves in its tree's order.
        Every stacked leaf is allocated once and each repeat is drawn into
        its row, so the peak is the parameters and one block more."""
        cfg, g = self.cfg, generator
        params = {
            "embed": layers.normal(g, (cfg.vocab, cfg.d_model),
                                   cfg.d_model ** -0.5, self.dtype, device),
            "final_norm": layers.rmsnorm_init(cfg.d_model, device),
            "head": [self._layer_init(g, blk, device)
                     for blk in cfg.head_blocks],
            "tail": [self._layer_init(g, blk, device) for blk in cfg.tail],
        }
        stack = {}
        for pos, blk in enumerate(cfg.pattern):
            first = self._layer_init(g, blk, device)
            if blk.shared:
                stack[str(pos)] = first
                continue
            rows = _alloc_stacked(first, cfg.n_repeats)
            _write_row(rows, first, 0)
            del first
            for r in range(1, cfg.n_repeats):
                _write_row(rows, self._layer_init(g, blk, device), r)
            stack[str(pos)] = rows
        params["stack"] = stack
        return params

    # ------------------------------------------------------------ masks

    def mask_sites(self) -> Dict[str, linearize.MaskSite]:
        cfg = self.cfg
        out = {}
        for i, blk in enumerate(cfg.head_blocks):
            for suf, site in _sites_for(cfg, blk).items():
                out[f"h{i}.{suf}"] = site
        for pos, blk in enumerate(cfg.pattern):
            for suf, site in _sites_for(cfg, blk).items():
                out[f"s{pos}.{suf}"] = dataclasses.replace(
                    site, shape=(cfg.n_repeats,) + site.shape)
        for i, blk in enumerate(cfg.tail):
            for suf, site in _sites_for(cfg, blk).items():
                out[f"t{i}.{suf}"] = site
        return out

    def relu_count(self) -> int:
        """Number of maskable nonlinearities (every mask coordinate)."""
        total = 0
        for s in self.mask_sites().values():
            n = 1
            for d in s.shape:
                n *= d
            total += n
        return total

    # ------------------------------------------------------------ blocks

    def _layer_apply(self, blk: Block, p, x, masks, prefix, opt, positions,
                     repeat=None, cache=None, cache_len=0):
        """One block.  ``prefix``: its place (``"h0"``, ``"s0"``, ``"t1"``),
        which with the block's site suffix names its mask site; ``repeat``:
        the stack row its (R, ·) mask and poly arrays are read at.
        ``cache``: the block's own cache (views of the model's cache
        tree), updated in place."""
        poly, soft, fused, ties = opt
        sites = _sites_for(self.cfg, blk)
        ms, plys = {}, {}
        for suf, site in sites.items():
            name = f"{prefix}.{suf}"
            m, ply = masks[name], poly.get(name)
            if repeat is not None:
                stacked = m.dim() == len(site.shape) + 2  # (N, R, *shape)
                m = m[:, repeat] if stacked else m[repeat]
                if ply is not None:                       # (3, R, *shape)
                    ply = ply[:, repeat]
            ms[suf], plys[suf] = m, ply
        if blk.kind == "mamba":
            mc = _mamba_cfg(self.cfg)
            h = layers.rmsnorm(p["ln"], x)
            kw = dict(poly=plys["mamba"], soft=soft, ties=ties)
            if cache is None:
                return x + ssm.mamba_block(p["mamba"], mc, h, ms["mamba"],
                                           sites["mamba"], **kw)
            y, (state, conv) = ssm.mamba_block(
                p["mamba"], mc, h, ms["mamba"], sites["mamba"],
                cache=(cache["ssm"], cache["conv"]), **kw)
            cache["ssm"].copy_(state)
            cache["conv"].copy_(conv)
            return x + y
        h = layers.rmsnorm(p["ln1"], x)
        if blk.kind == "rwkv":
            (suf, site), = sites.items()
            m, ply = ms[suf], plys[suf]
            rc = _rwkv_cfg(self.cfg)
            if cache is None:
                x = x + ssm.rwkv_time_mix(p["tmix"], rc, h)
                h = layers.rmsnorm(p["ln2"], x)
                return x + ssm.rwkv_channel_mix(p["tmix"], rc, h, m, site,
                                                poly=ply, soft=soft,
                                                ties=ties)
            y, (state, ptm) = ssm.rwkv_time_mix(
                p["tmix"], rc, h, cache=(cache["state"], cache["ptm"]))
            cache["state"].copy_(state)
            cache["ptm"].copy_(ptm)
            x = x + y
            h = layers.rmsnorm(p["ln2"], x)
            y, pcm = ssm.rwkv_channel_mix(p["tmix"], rc, h, m, site,
                                          poly=ply, soft=soft, ties=ties,
                                          cache=cache["pcm"])
            cache["pcm"].copy_(pcm)
            return x + y
        ac = _attn_cfg(self.cfg, blk)
        if cache is None:
            x = x + layers.attention(p["attn"], ac, h, positions)
        else:
            x = x + layers.attention(p["attn"], ac, h, positions,
                                     kv_cache=cache["kv"],
                                     cache_len=cache_len)[0]
        if blk.kind == "attn_only":
            return x
        h = layers.rmsnorm(p["ln2"], x)
        if blk.kind == "moe":
            return x + moe_lib.moe_ffn(
                p["moe"], _moe_cfg(self.cfg), h, ms["moe"], sites["moe"],
                ms.get("moe_shared"), sites.get("moe_shared"),
                poly=plys["moe"], shared_poly=plys.get("moe_shared"),
                soft=soft, fused=fused, ties=ties)
        return x + layers.ffn(p["ffn"], h, ms["ffn"], sites["ffn"],
                              poly=plys["ffn"], soft=soft, fused=fused,
                              ties=ties)

    # The forward is a fold over segments: 0 = the embedding (done before
    # the fold), 1..H = head blocks, 1+H..H+R = stack repeats, then the tail
    # blocks; the final norm and the logits follow the last one.  forward,
    # forward_prefix and forward_suffix fold the same list, so
    # prefix ∘ suffix == forward by construction.

    def _n_segments(self) -> int:
        cfg = self.cfg
        return 1 + len(cfg.head_blocks) + cfg.n_repeats + len(cfg.tail)

    def _fold(self, params, masks, x, lo: int, hi: int, opt, cache=None,
              cache_len=0):
        """Run segments ``[lo, hi)`` (lo >= 1) on the hidden state x;
        ``cache`` (serving) is updated in place."""
        cfg = self.cfg
        H, R = len(cfg.head_blocks), cfg.n_repeats
        if cache is None:
            positions = torch.arange(x.shape[-2], device=x.device)
        else:
            positions = _positions(x.shape[0], x.shape[1], cache_len,
                                   x.device)
        # a stacked block's parameter rows, unbound once a fold: the
        # gradient of ``torch.unbind`` is one stack, where indexing row by
        # row (``_index``) would add a zero-padded full-size gradient a
        # repeat
        rows = {}
        for seg in range(max(lo, 1), hi):
            if seg <= H:
                i = seg - 1
                x = self._layer_apply(
                    cfg.head_blocks[i], params["head"][i], x, masks, f"h{i}",
                    opt, positions, cache=None if cache is None
                    else cache["head"][i], cache_len=cache_len)
            elif seg <= H + R:
                r = seg - 1 - H
                for pos, blk in enumerate(cfg.pattern):
                    lp = params["stack"][str(pos)]
                    if not blk.shared:
                        if pos not in rows:
                            rows[pos] = _unbind(lp)
                        lp = rows[pos][r]
                    lc = None if cache is None \
                        else _index(cache["stack"][str(pos)], r)
                    x = self._layer_apply(blk, lp, x, masks, f"s{pos}", opt,
                                          positions, repeat=r, cache=lc,
                                          cache_len=cache_len)
            else:
                i = seg - 1 - H - R
                x = self._layer_apply(
                    cfg.tail[i], params["tail"][i], x, masks, f"t{i}", opt,
                    positions, cache=None if cache is None
                    else cache["tail"][i], cache_len=cache_len)
        return x

    def _logits(self, params, x):
        x = layers.rmsnorm(params["final_norm"], x)
        return x @ params["embed"].T.to(x.dtype)

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()]

    # ------------------------------------------------------------ forward

    def forward(self, params, masks, tokens, *, prefix_embeds=None,
                poly=None, soft=False, cache=None, cache_len=0, pre=None,
                fused=False, ties=True):
        """Logits ``(B, S, V)``, or ``(N, B, S, V)`` for stacked masks.

        ``pre``: a cached :meth:`forward_pre` result (the mask-independent
        embedding) — ``tokens`` is then ignored.  ``prefix_embeds``:
        ``(B, P, D)`` stub-frontend embeddings put before the tokens'.
        ``fused``: every hard-mask FFN runs gate → down-projection as one
        kernel.  ``ties=False`` promises that no mask coordinate is
        share-tied (decided on the host, ``linearize.has_share_ties``).

        ``cache`` (prefill and decode; one mask tree, not stacked): a tree
        from :meth:`init_cache`, the reference's — ``{"head": [block
        cache, …], "stack": {"<pattern position>": block cache with a
        leading repeats axis on every leaf}, "tail": [block cache, …]}``,
        where a dense block's cache is ``{"kv": (K, V)}``, each (B,
        max_len, KV, hd) in the model's dtype (a ``moe`` and an
        ``attn_only`` block's too), a Mamba2 block's is ``{"ssm": (B, nh,
        N, hd) float32, "conv": (B, d_conv - 1, d_inner)}`` (the scan state
        and the convolution's trailing inputs) and an RWKV-6 block's is
        ``{"state": (B, H, hd, hd) float32, "ptm": (B, D), "pcm": (B, D)}``
        (the scan state and the time- and channel-mix shifts' last
        inputs).  The tokens sit at positions ``cache_len …`` — an int, or
        a (B,) array or tensor of per-row positions (ragged decode).  The
        cache is updated **in place**; returns ``(logits, cache)``, the
        same tree.  Without a cache returns the logits alone."""
        opt = (poly or {}, soft, fused, ties)
        if cache is not None:
            sites = self.mask_sites()
            if any(masks[k].dim() != len(s.shape) for k, s in sites.items()):
                raise ValueError("forward(cache=): one mask tree, not a "
                                 "stack of candidates")
        if pre is not None:
            x = pre
        else:
            x = self._embed(params, tokens)
            if prefix_embeds is not None:
                x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        if cache is None:
            x = self._fold(params, masks, x, 1, self._n_segments(), opt)
            return self._logits(params, x)
        cache_len = _cache_len(cache_len, x.shape[0], x.device)
        x = self._fold(params, masks, x, 1, self._n_segments(), opt,
                       cache=cache, cache_len=cache_len)
        return self._logits(params, x), cache

    def forward_pre(self, params, tokens):
        """The mask-independent head of the network, the token embedding:
        computed once per evaluator context and fed back through
        ``forward(..., pre=...)``."""
        return self._embed(params, tokens)

    # ------------------------------------------------------- split forward
    #
    # Segment boundaries for prefix-reuse candidate evaluation
    # (core.engine.SuffixEvaluator): embed | head block i … | stack repeat 0
    # … stack repeat R-1 | tail block i … | final norm + logits.  Stack
    # sites are addressed two ways: the real mask name ("s0.ffn", whose
    # (R, ·) array spans every repeat) maps to its repeat-0 segment, and
    # virtual repeat-qualified names ("s0.ffn@r") address the per-repeat
    # segments — a cut at repeat r resumes the stack loop at repeat r.

    def _segment_of_site(self) -> Dict[str, int]:
        cfg = self.cfg
        H = len(cfg.head_blocks)
        R = cfg.n_repeats
        out = {}
        for i, blk in enumerate(cfg.head_blocks):
            for suf in _sites_for(cfg, blk):
                out[f"h{i}.{suf}"] = 1 + i
        for pos, blk in enumerate(cfg.pattern):
            for suf in _sites_for(cfg, blk):
                out[f"s{pos}.{suf}"] = 1 + H
                for r in range(R):
                    out[f"s{pos}.{suf}@{r}"] = 1 + H + r
        for i, blk in enumerate(cfg.tail):
            for suf in _sites_for(cfg, blk):
                out[f"t{i}.{suf}"] = 1 + H + R + i
        return out

    def site_repeats(self) -> Dict[str, int]:
        """Real stack mask name -> repeat count its (R, ·) array spans.

        A stack site's per-repeat segments are consecutive from its base
        (repeat-0) segment, and its flat mask coordinates are laid out
        repeat-major, so a coordinate's segment is
        ``base + local_offset // (size // R)``
        (``masks.group_blocks_by_site`` ``repeat_sites=``)."""
        cfg = self.cfg
        return {f"s{pos}.{suf}": cfg.n_repeats
                for pos, blk in enumerate(cfg.pattern)
                for suf in _sites_for(cfg, blk)}

    def site_order(self) -> Tuple[str, ...]:
        """All mask sites in forward order: stack sites once per repeat
        under their virtual name (``"s0.ffn@1"``), head and tail sites under
        their real name; real stack names are absent."""
        seg = self._segment_of_site()
        reps = self.site_repeats()
        return tuple(sorted((s for s in seg if s not in reps),
                            key=lambda s: (seg[s], s)))

    def site_segments(self) -> Dict[str, int]:
        """site -> segment index, under both namings of stack sites: real
        mask names at their repeat-0 segment (mask-tree diffing, grouping)
        and virtual ``@r`` names at repeat r's segment (cuts)."""
        return self._segment_of_site()

    def suffix_sites(self, site: str) -> Tuple[str, ...]:
        """Real mask names consumed by :meth:`forward_suffix` for this cut:
        those whose DEEPEST segment is at or after it.  A stack site's
        (R, ·) array reaches repeat R-1, so a cut at any repeat ships the
        whole array (the rows before the cut are not read)."""
        seg = self._segment_of_site()
        cut = seg[site]
        reps = self.site_repeats()

        def deepest(s):
            return seg[s] + (reps[s] - 1 if s in reps else 0)
        return tuple(s for s in sorted((k for k in seg if "@" not in k),
                                       key=lambda s: (seg[s], s))
                     if deepest(s) >= cut)

    def forward_prefix(self, params, masks, tokens, site, *, poly=None,
                       soft=False, from_site=None, cached=None, fused=False,
                       ties=True):
        """Forward up to (excluding) the segment applying ``site``; returns
        the (B, S, D) hidden state at that boundary.  A cut at repeat r
        (``"s0.ffn@r"``) stops the stack after repeat r-1.

        ``from_site``/``cached`` resume from an earlier prefix's boundary
        state instead of the embedding, folding only the segments in
        ``[seg(from_site), seg(site))`` — the prefix-trie extension
        contract ``prefix_ext(a, b, m, prefix(a)) == prefix(b)``."""
        opt = (poly or {}, soft, fused, ties)
        seg = self._segment_of_site()
        if from_site is None:
            x, lo = self._embed(params, tokens), 1
        else:
            x, lo = cached, seg[from_site]
        return self._fold(params, masks, x, lo, seg[site], opt)

    def forward_suffix(self, params, masks, cached, site, *, poly=None,
                       soft=False, fused=False, ties=True):
        """Finish the forward from a :meth:`forward_prefix` state: the
        segment applying ``site`` and everything after it, to logits.  With
        stacked masks the shared ``cached`` state is read by every candidate
        and never broadcast in memory."""
        opt = (poly or {}, soft, fused, ties)
        cut = self._segment_of_site()[site]
        x = self._fold(params, masks, cached, cut, self._n_segments(), opt)
        return self._logits(params, x)

    def site_prefix_fractions(self, *, seq_len: int = 64) -> Dict[str, float]:
        """site -> fraction of forward FLOPs strictly before its segment
        (``analysis.roofline.lm_segment_fwd_flops``, per sample, prefill),
        under both namings of stack sites."""
        from repro_torch.analysis import roofline
        seg_flops = roofline.lm_segment_fwd_flops(self.cfg, seq_len=seq_len)
        total = max(sum(seg_flops), 1.0)
        before, cum = [], 0.0
        for v in seg_flops:
            before.append(cum / total)
            cum += v
        return {s: before[i] for s, i in self._segment_of_site().items()}

    # ------------------------------------------------------- eval closures
    #
    # Same contract as models.resnet.CNN: a device closure that takes one
    # mask tree or N stacked ones and returns accuracy tensors without
    # synchronising, and a host callable for the sequential engine.  The
    # metric is next-token accuracy [%] on a fixed token batch
    # (``batch["tokens"]`` (B, S+1): inputs tokens[:, :-1], labels
    # tokens[:, 1:]).

    def make_param_eval_fn(self, batch, device="cuda"):
        """``(mask_tree, params, ties=True) -> accuracy[%]`` on ``device``,
        params as evaluator context (they change between BCD steps when a
        run finetunes)."""
        tokens = to_device(batch["tokens"], device)

        def eval_fn(masks, params, ties=True):
            logits = self.forward(params, masks, tokens[:, :-1], ties=ties)
            return token_accuracy(logits, tokens[:, 1:])
        return eval_fn

    def make_eval_fn(self, params, batch, device="cuda"):
        fn = self.make_param_eval_fn(batch, device)
        return lambda masks, ties=True: fn(masks, params, ties=ties)

    def make_joint_eval_fn(self):
        """``(mask_tree, ctx, ties=True) -> accuracy[%]`` with
        ``ctx = {"params": ..., "batch": ...}``; ``ctx["pre"]`` (optional)
        is the embedding, computed once per context by the evaluator."""
        def eval_fn(masks, ctx, ties=True):
            tokens = ctx["batch"]["tokens"]
            logits = self.forward(ctx["params"], masks, tokens[:, :-1],
                                  pre=ctx.get("pre"), ties=ties)
            return token_accuracy(logits, tokens[:, 1:])
        return eval_fn

    def make_suffix_eval_fns(self):
        """Split-forward closure bundle for ``engine.SuffixEvaluator`` —
        the contract of ``CNN.make_suffix_eval_fns``, with the per-repeat
        stack cuts described by ``site_repeats``."""
        from repro_torch.core import engine

        def prefix_fn(site, masks, ctx, ties=True):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["tokens"][:, :-1], site,
                                       ties=ties)

        def prefix_ext_fn(from_site, site, masks, cached, ctx, ties=True):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["tokens"][:, :-1], site,
                                       from_site=from_site, cached=cached,
                                       ties=ties)

        def suffix_fn(site, masks, cached, ctx, fused=False, ties=True):
            logits = self.forward_suffix(ctx["params"], masks, cached, site,
                                         fused=fused, ties=ties)
            return token_accuracy(logits, ctx["batch"]["tokens"][:, 1:])

        def pre_fn(ctx):
            return self.forward_pre(ctx["params"],
                                    ctx["batch"]["tokens"][:, :-1])

        return engine.SplitEval(
            prefix=prefix_fn, suffix=suffix_fn,
            full=self.make_joint_eval_fn(),
            site_order=self.site_order(),
            site_segment=self.site_segments(),
            suffix_sites=self.suffix_sites,
            prefix_fraction=self.site_prefix_fractions(),
            prefix_ext=prefix_ext_fn,
            pre=pre_fn,
            site_repeats=self.site_repeats())

    def make_eval_acc(self, params, batch, device="cuda"):
        """Host callable ``mask_tree -> float`` (one candidate); reads the
        result back, so it synchronises once per call."""
        fn = self.make_eval_fn(params, batch, device)

        def eval_acc(masks):
            ties = linearize.has_share_ties(masks)
            with torch.no_grad():
                return float(fn(M.as_device(masks, device), ties=ties))
        return eval_acc


    # ------------------------------------------------------------ cache

    def _layer_cache(self, blk: Block, B: int, max_len: int, device):
        cfg, dt = self.cfg, self.dtype
        if blk.kind == "mamba":
            mc = _mamba_cfg(cfg)
            return {"ssm": torch.zeros((B, mc.n_heads, mc.d_state,
                                        mc.head_dim), dtype=torch.float32,
                                       device=device),
                    "conv": torch.zeros((B, mc.d_conv - 1, mc.d_inner),
                                        dtype=dt, device=device)}
        if blk.kind == "rwkv":
            rc = _rwkv_cfg(cfg)
            return {"state": torch.zeros((B, rc.n_heads, rc.head_dim,
                                          rc.head_dim), dtype=torch.float32,
                                         device=device),
                    "ptm": torch.zeros((B, cfg.d_model), dtype=dt,
                                       device=device),
                    "pcm": torch.zeros((B, cfg.d_model), dtype=dt,
                                       device=device)}
        kv_shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"kv": (torch.zeros(kv_shape, dtype=dt, device=device),
                       torch.zeros(kv_shape, dtype=dt, device=device))}

    def init_cache(self, B: int, max_len: int, device="cuda"):
        """A zero cache for B sequences of up to ``max_len`` tokens, in the
        tree :meth:`forward` documents; the stack's leaves carry a leading
        repeats axis (a shared block's too: its parameters are shared, its
        caches are not) and every leaf is a tensor of its own (they are
        written in place)."""
        cfg, R = self.cfg, self.cfg.n_repeats
        stack = {}
        for pos, blk in enumerate(cfg.pattern):
            stack[str(pos)] = _stack_trees(
                [self._layer_cache(blk, B, max_len, device)
                 for _ in range(R)])
        return {"head": [self._layer_cache(b, B, max_len, device)
                         for b in cfg.head_blocks],
                "stack": stack,
                "tail": [self._layer_cache(b, B, max_len, device)
                         for b in cfg.tail]}


def _positions(B: int, S: int, cache_len, device):
    """(B, S) absolute positions from an int ``cache_len`` (every row at the
    same offset) or a (B,) tensor of per-row offsets (ragged decode)."""
    steps = torch.arange(S, device=device)
    if isinstance(cache_len, torch.Tensor):
        return steps[None, :] + cache_len[:, None]
    return (steps + cache_len)[None, :].expand(B, S)


def _cache_len(cache_len, B: int, device):
    """``cache_len`` as an int, or as a (B,) int64 tensor on ``device``."""
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        t = cache_len
    else:
        a = np.asarray(cache_len.cpu() if isinstance(cache_len, torch.Tensor)
                       else cache_len)
        if a.ndim == 0:
            return int(a)
        t = torch.as_tensor(a)
    if tuple(t.shape) != (B,):
        raise ValueError(f"cache_len must be an int or ({B},), got "
                         f"{tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int64)


def _alloc_stacked(tree, n: int):
    """Uninitialised leaves ``(n, *leaf.shape)`` for a parameter tree."""
    if isinstance(tree, dict):
        return {k: _alloc_stacked(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _write_row(rows, tree, r: int):
    """Copy a parameter tree into row ``r`` of its stacked leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _write_row(rows[k], v, r)
    else:
        rows[r].copy_(tree)


def _stack_trees(trees):
    """A list of equal parameter (or cache) trees -> one tree of stacked
    leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_trees([t[i] for t in trees])
                     for i in range(len(first)))
    return torch.stack(trees)


def _unbind(tree) -> list:
    """Every row of a stacked parameter tree: a list of trees of views, one
    ``torch.unbind`` a leaf."""
    if isinstance(tree, dict):
        per = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    return list(torch.unbind(tree))


def _index(tree, r: int):
    """Row ``r`` of every leaf of a stacked parameter (or cache) tree, as
    views."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, r) for v in tree)
    return tree[r]
