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
that.  Given the host decision ``differ=``
(``linearize.first_differences``), a site or stack repeat that every
candidate shares is gated with its one mask while the activation is shared,
so the first stacked gate is the first one where the candidates differ.  A
MoE block routes per row of that explicit axis (``models.moe``).  Under
``fused=`` dense FFNs and MoE shared experts take the fused gate→matmul
kernels; routed experts, Mamba2 and RWKV blocks stay on the gate route, as
the reference routes them.

**Serving** (``forward(cache=, cache_len=)``, :meth:`LM.init_cache`):
``dense``, ``moe`` and ``attn_only`` blocks keep a KV cache, a Mamba2
block its scan state and its convolution's trailing inputs, an RWKV-6
block its scan state and the two token shifts' last inputs, in the
reference's cache tree.  The port writes the cache **in place** where the
reference returns a new one.

**On a mesh** (``LM(cfg, mesh)``, a ``("data", "model")`` mesh of ranks):
the reference's placement rules (``param_specs``, ``cache_specs``, at the
end of this module) and the layouts the port holds (``held_param_specs``,
``held_cache_specs``); under ``model > 1`` the forward is tensor-parallel,
its collectives written out (``core.spmd``): attention, the RWKV-6
time-mix and the Mamba2 block on the rank's heads, FFNs, the channel-mix
and every MoE expert on its block of d_ff columns, the embedding and the
logits on its block of the vocabulary.  A config whose heads or expert
columns do not split over the axis is refused
(:func:`_check_tensor_parallel`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.configs.base import ArchConfig, Block
from repro_torch.convert import to_device
from repro_torch.core import linearize, masks as M, spmd
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
    the same float32 number.  Stays on the device.  Under a batch split
    (``core.spmd``) the hit count is summed over the ranks and divided once
    by the global position count."""
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    # under a batch split (core.spmd) the count is summed over the ranks
    return spmd.batch_sum(hit.sum(dim=(-2, -1))) / float(
        labels.numel() * spmd.batch_ranks()) * 100.0


class LM:
    """The LM of every block kind: plain functions over a parameter tree.

    Building one turns TF32 off process-wide
    (:func:`repro_torch.use_full_float32`): the fused kernels accumulate in
    exact float32, and every evaluation path must rank candidates alike."""

    def __init__(self, cfg: ArchConfig, mesh=None):
        blocks = tuple(cfg.head_blocks) + tuple(cfg.pattern) + tuple(cfg.tail)
        for blk in blocks:
            _sites_for(cfg, blk)          # raises for an unknown kind
        repro_torch.use_full_float32()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32
        self._place(mesh)

    # ------------------------------------------------------------ mesh

    def _place(self, mesh) -> None:
        """The model's place on a ``("data", "model")`` mesh (``None``: one
        rank).  Under ``model > 1`` every forward is tensor-parallel: the
        parameters are the rank's shards (:func:`held_param_specs`), the
        attention, the RWKV time-mix and the Mamba2 block run on the
        rank's heads, FFNs and MoE experts on its block of d_ff columns,
        the embedding and the logits on its block of the vocabulary.
        ``fsdp_specs`` (set by the sharded train step) names the
        parameters split over ``"data"`` (ZeRO-3), gathered as each block
        runs."""
        from repro_torch.launch import mesh as mesh_lib
        self.mesh = mesh
        self.data_axis = mesh_lib.axis(mesh, "data")
        self.model_axis = mesh_lib.axis(mesh, "model")
        self._tp = self.model_axis if self.model_axis.size > 1 else None
        self.fsdp_specs = None
        if self._tp is not None:
            _check_tensor_parallel(self.cfg, self.model_axis.size)

    def on_mesh(self, mesh) -> "LM":
        """This model placed on ``mesh`` (itself where it already is)."""
        if mesh is self.mesh:
            return self
        return LM(self.cfg, mesh)

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
        poly, soft, fused, ties, differ = opt
        sites = _sites_for(self.cfg, blk)
        shared_x = differ is not None and x.dim() == 3
        ms, plys = {}, {}
        for suf, site in sites.items():
            name = f"{prefix}.{suf}"
            m, ply = masks[name], poly.get(name)
            if shared_x:
                m = linearize.shared_mask(m, differ, name, repeat)
            if repeat is not None:
                stacked = m.dim() == len(site.shape) + 2  # (N, R, *shape)
                m = m[:, repeat] if stacked else m[repeat]
                if ply is not None:                       # (3, R, *shape)
                    ply = ply[:, repeat]
            ms[suf], plys[suf] = m, ply
        if blk.kind == "mamba":
            mc = _mamba_cfg(self.cfg)
            h = layers.rmsnorm(p["ln"], x)
            kw = dict(poly=plys["mamba"], soft=soft, ties=ties, tp=self._tp)
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
            tp = self._tp
            if cache is None:
                x = x + ssm.rwkv_time_mix(p["tmix"], rc, h, tp=tp)
                h = layers.rmsnorm(p["ln2"], x)
                return x + ssm.rwkv_channel_mix(p["tmix"], rc, h, m, site,
                                                poly=ply, soft=soft,
                                                ties=ties, tp=tp)
            y, (state, ptm) = ssm.rwkv_time_mix(
                p["tmix"], rc, h, cache=(cache["state"], cache["ptm"]),
                tp=tp)
            cache["state"].copy_(state)
            cache["ptm"].copy_(ptm)
            x = x + y
            h = layers.rmsnorm(p["ln2"], x)
            y, pcm = ssm.rwkv_channel_mix(p["tmix"], rc, h, m, site,
                                          poly=ply, soft=soft, ties=ties,
                                          cache=cache["pcm"], tp=tp)
            cache["pcm"].copy_(pcm)
            return x + y
        ac = _attn_cfg(self.cfg, blk)
        if cache is None:
            x = x + layers.attention(p["attn"], ac, h, positions,
                                     tp=self._tp)
        else:
            x = x + layers.attention(p["attn"], ac, h, positions,
                                     kv_cache=cache["kv"],
                                     cache_len=cache_len, tp=self._tp)[0]
        if blk.kind == "attn_only":
            return x
        h = layers.rmsnorm(p["ln2"], x)
        if blk.kind == "moe":
            return x + moe_lib.moe_ffn(
                p["moe"], _moe_cfg(self.cfg), h, ms["moe"], sites["moe"],
                ms.get("moe_shared"), sites.get("moe_shared"),
                poly=plys["moe"], shared_poly=plys.get("moe_shared"),
                soft=soft, fused=fused, ties=ties, tp=self._tp)
        return x + layers.ffn(p["ffn"], h, ms["ffn"], sites["ffn"],
                              poly=plys["ffn"], soft=soft, fused=fused,
                              ties=ties, tp=self._tp)

    # The forward is a fold over segments: 0 = the embedding (done before
    # the fold), 1..H = head blocks, 1+H..H+R = stack repeats, then the tail
    # blocks; the final norm and the logits follow the last one.  forward,
    # forward_prefix and forward_suffix fold the same list, so
    # prefix ∘ suffix == forward by construction.

    def _n_segments(self) -> int:
        cfg = self.cfg
        return 1 + len(cfg.head_blocks) + cfg.n_repeats + len(cfg.tail)

    def _fold(self, params, masks, x, lo: int, hi: int, opt, cache=None,
              cache_len=0, remat=False, upcast=False):
        """Run segments ``[lo, hi)`` (lo >= 1) on the hidden state x;
        ``cache`` (serving) is updated in place.  ``remat`` (no cache):
        the stack repeats run under ``torch.utils.checkpoint``, as the
        reference's ``_run_stack(remat=True)`` scans them.  ``upcast``:
        each block's parameters are cast to the model's dtype as the block
        runs."""
        cfg = self.cfg
        fs = self.fsdp_specs

        def up(p, spec=None):
            if spec is not None:
                p = _gather_data(p, spec, self.data_axis)
            return _cast_tree(p, self.dtype) if upcast else p
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

        def repeat(x, r):
            for pos, blk in enumerate(cfg.pattern):
                lp = params["stack"][str(pos)]
                spec = None if fs is None else fs["stack"][str(pos)]
                if not blk.shared:
                    lp = rows[pos][r]
                    spec = None if spec is None else _row_specs(spec)
                lc = None if cache is None \
                    else _index(cache["stack"][str(pos)], r)
                x = self._layer_apply(blk, up(lp, spec), x, masks, f"s{pos}",
                                      opt, positions, repeat=r, cache=lc,
                                      cache_len=cache_len)
            return x

        for seg in range(max(lo, 1), min(hi, H + 1)):
            i = seg - 1
            x = self._layer_apply(
                cfg.head_blocks[i], up(params["head"][i],
                                       None if fs is None else fs["head"][i]),
                x, masks, f"h{i}", opt, positions, cache=None if cache is None
                else cache["head"][i], cache_len=cache_len)
        reps = range(max(lo - 1 - H, 0), min(hi - 1 - H, R))
        if len(reps):
            for pos, blk in enumerate(cfg.pattern):
                if not blk.shared:
                    rows[pos] = _unbind(params["stack"][str(pos)])
            x = _run_repeats(repeat, x, reps,
                             remat and cache is None, cfg.remat_group)
        for seg in range(max(lo, H + R + 1), hi):
            i = seg - 1 - H - R
            x = self._layer_apply(
                cfg.tail[i], up(params["tail"][i],
                                None if fs is None else fs["tail"][i]),
                x, masks, f"t{i}", opt, positions, cache=None if cache is None
                else cache["tail"][i], cache_len=cache_len)
        return x

    def _vocab_split(self, embed) -> bool:
        """Whether ``embed`` holds the rank's block of the vocabulary."""
        return self._tp is not None and embed.shape[0] != self.cfg.vocab

    def _logits(self, params, x, return_hidden=False):
        """The final norm, then the logits ``x @ embed.T``: under a split
        vocabulary, the rank's block of them (``(…, V / size)``)."""
        x = layers.rmsnorm(params["final_norm"], x)
        if return_hidden:
            return x
        emb = params["embed"]
        if self._vocab_split(emb):
            x = spmd.enter(x, self._tp)
        return x @ emb.T.to(x.dtype)

    def _embed(self, params, tokens):
        """The token embedding; under a split vocabulary each rank looks up
        the tokens of its block (the rest read 0) and the axis sums."""
        emb = params["embed"]
        if not self._vocab_split(emb):
            return emb[tokens.long()]
        n = emb.shape[0]
        t = tokens.long() - self._tp.index * n
        ok = (t >= 0) & (t < n)
        rows = torch.where(ok[..., None], emb[torch.where(ok, t, 0)], 0)
        return spmd.all_reduce_sum(rows, self._tp)

    # ------------------------------------------------------------ forward

    def forward(self, params, masks, tokens, *, prefix_embeds=None,
                poly=None, soft=False, cache=None, cache_len=0, pre=None,
                fused=False, ties=True, remat=False, return_hidden=False,
                upcast=False, differ=None):
        """Logits ``(B, S, V)``, or ``(N, B, S, V)`` for stacked masks.

        ``pre``: a cached :meth:`forward_pre` result (the mask-independent
        embedding) — ``tokens`` is then ignored.  ``prefix_embeds``:
        ``(B, P, D)`` stub-frontend embeddings put before the tokens'.
        ``fused``: every hard-mask FFN runs gate → down-projection as one
        kernel.  ``ties=False`` promises that no mask coordinate is
        share-tied (decided on the host, ``linearize.has_share_ties``).
        ``differ`` (stacked masks): the host decision
        ``linearize.first_differences``; sites and repeats that every
        candidate shares are gated with one mask while the activation is
        shared, and where none differs the logits stay ``(B, S, V)``.

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
        same tree.  Without a cache returns the logits alone.

        ``remat`` (training, no cache): each stack repeat runs under
        ``torch.utils.checkpoint`` and is recomputed in the backward; with
        ``cfg.remat_group = G > 1`` dividing the repeats, groups of G
        repeats are checkpointed and each repeat within a group again (the
        reference's hierarchical remat).  Head and tail blocks are not.
        The forward and the gradients are the bits of ``remat=False``.
        ``return_hidden``: the final-norm hidden state ``(B, S, D)`` in
        place of the logits (the caller owns the head's product, e.g. a
        chunked loss).

        ``upcast`` (no cache): ``params`` may be of a narrower dtype (a
        bfloat16 model's); each block's, the embedding's and the final
        norm's are cast to this model's dtype as they are used, one block
        at a time — a float32 model's forward of a bfloat16 model's
        parameters, with no float32 copy of them all."""
        opt = (poly or {}, soft, fused, ties, differ)
        if upcast and cache is not None:
            raise ValueError("forward(upcast=True) takes no cache")
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
            if upcast:
                x = x.to(self.dtype)
                params = dict(params, final_norm=_cast_tree(
                    params["final_norm"], self.dtype))
            x = self._fold(params, masks, x, 1, self._n_segments(), opt,
                           remat=remat, upcast=upcast)
            return self._logits(params, x, return_hidden)
        cache_len = _cache_len(cache_len, x.shape[0], x.device)
        x = self._fold(params, masks, x, 1, self._n_segments(), opt,
                       cache=cache, cache_len=cache_len)
        return self._logits(params, x, return_hidden), cache

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
        opt = (poly or {}, soft, fused, ties, None)
        seg = self._segment_of_site()
        if from_site is None:
            x, lo = self._embed(params, tokens), 1
        else:
            x, lo = cached, seg[from_site]
        return self._fold(params, masks, x, lo, seg[site], opt)

    def forward_suffix(self, params, masks, cached, site, *, poly=None,
                       soft=False, fused=False, ties=True, differ=None):
        """Finish the forward from a :meth:`forward_prefix` state: the
        segment applying ``site`` and everything after it, to logits.  With
        stacked masks the shared ``cached`` state is read by every candidate
        and never broadcast in memory; ``differ`` as :meth:`forward`."""
        opt = (poly or {}, soft, fused, ties, differ)
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
        """``(mask_tree, params, ties=True, differ=None, fused=False) ->
        accuracy[%]`` on ``device``, params as evaluator context (they
        change between BCD steps when a run finetunes)."""
        tokens = to_device(batch["tokens"], device)

        def eval_fn(masks, params, ties=True, differ=None, fused=False):
            logits = self.forward(params, masks, tokens[:, :-1], ties=ties,
                                  differ=differ, fused=fused)
            return linearize.per_candidate(
                token_accuracy(logits, tokens[:, 1:]), masks, differ)
        return eval_fn

    def make_eval_fn(self, params, batch, device="cuda"):
        fn = self.make_param_eval_fn(batch, device)
        return lambda masks, ties=True, differ=None, fused=False: fn(
            masks, params, ties=ties, differ=differ, fused=fused)

    def make_joint_eval_fn(self):
        """``(mask_tree, ctx, ties=True, differ=None, fused=False) ->
        accuracy[%]`` with ``ctx = {"params": ..., "batch": ...}``;
        ``ctx["pre"]`` (optional) is the embedding, computed once per
        context by the evaluator."""
        def eval_fn(masks, ctx, ties=True, differ=None, fused=False):
            tokens = ctx["batch"]["tokens"]
            logits = self.forward(ctx["params"], masks, tokens[:, :-1],
                                  pre=ctx.get("pre"), ties=ties,
                                  differ=differ, fused=fused)
            return linearize.per_candidate(
                token_accuracy(logits, tokens[:, 1:]), masks, differ)
        return eval_fn

    def make_suffix_eval_fns(self):
        """Split-forward closure bundle for ``engine.SuffixEvaluator`` —
        the contract of ``CNN.make_suffix_eval_fns``, with the per-repeat
        stack cuts described by ``site_repeats``.  Every closure takes
        ``fused=``, the run's one route (``pre``, the embedding, has no
        gate)."""
        from repro_torch.core import engine

        def prefix_fn(site, masks, ctx, ties=True, fused=False):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["tokens"][:, :-1], site,
                                       ties=ties, fused=fused)

        def prefix_ext_fn(from_site, site, masks, cached, ctx, ties=True,
                          fused=False):
            return self.forward_prefix(ctx["params"], masks,
                                       ctx["batch"]["tokens"][:, :-1], site,
                                       from_site=from_site, cached=cached,
                                       ties=ties, fused=fused)

        def suffix_fn(site, masks, cached, ctx, fused=False, ties=True,
                      differ=None):
            logits = self.forward_suffix(ctx["params"], masks, cached, site,
                                         fused=fused, ties=ties,
                                         differ=differ)
            return linearize.per_candidate(
                token_accuracy(logits, ctx["batch"]["tokens"][:, 1:]), masks,
                differ)

        def pre_fn(ctx, fused=False):
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

    def make_eval_acc(self, params, batch, device="cuda", fused=False):
        """Host callable ``mask_tree -> float`` (one candidate); reads the
        result back, so it synchronises once per call.  ``fused``: the
        run's route; a tree that carries share ties runs unfused."""
        fn = self.make_eval_fn(params, batch, device)

        def eval_acc(masks):
            ties = linearize.has_share_ties(masks)
            with torch.no_grad():
                return float(fn(M.as_device(masks, device), ties=ties,
                                fused=fused and not ties))
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
        written in place).  On a mesh, the rank's held piece of it
        (:func:`held_cache_specs`): the B sequences split over ``"data"``
        where they divide, heads over ``"model"``."""
        cfg, R = self.cfg, self.cfg.n_repeats
        if self.mesh is not None and torch.device(device).type != "meta":
            shapes = LM(cfg).init_cache(B, max_len, "meta")
            specs = held_cache_specs(shapes, ("data",), self.data_axis.size,
                                     B, self.data_axis.size,
                                     self.model_axis.size)
            sizes = {"data": self.data_axis.size,
                     "model": self.model_axis.size}
            return _map_specs(
                lambda t, sp: torch.zeros(spmd.local_shape(t.shape, sp,
                                                           sizes),
                                          dtype=t.dtype, device=device),
                shapes, specs)
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

    def param_shapes(self):
        """The parameter tree on the ``"meta"`` device: shapes and dtypes,
        no storage (the reference's ``jax.eval_shape(model.init)``)."""
        return LM(self.cfg).init(None, "meta")


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


def _checkpoint(fn, *args):
    # nothing in the forward draws random numbers: no RNG state to keep
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run_repeats(repeat, x, reps: range, remat: bool, group: int):
    """``repeat(x, r)`` for r in ``reps``, in order.  ``remat``: each under
    a checkpoint, or, with ``group = G > 1`` dividing ``len(reps)``, each
    run of G repeats under one and each repeat within it under another."""
    if not remat:
        for r in reps:
            x = repeat(x, r)
        return x
    if group > 1 and len(reps) % group == 0:
        def run_group(x, r0):
            for r in range(r0, r0 + group):
                x = _checkpoint(repeat, x, r)
            return x
        for r0 in reps[::group]:
            x = _checkpoint(run_group, x, r0)
        return x
    for r in reps:
        x = _checkpoint(repeat, x, r)
    return x


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


def _cast_tree(tree, dtype):
    """Every floating leaf of a parameter tree in ``dtype`` (a leaf already
    of it as it is)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def _index(tree, r: int):
    """Row ``r`` of every leaf of a stacked parameter (or cache) tree, as
    views."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, r) for v in tree)
    return tree[r]


def _gather_data(tree, specs, axis):
    """A block's parameters with every leaf split over ``"data"`` (ZeRO-3)
    gathered whole along that dimension (its gradient reduce-scattered)."""
    if isinstance(tree, dict):
        return {k: _gather_data(v, specs[k], axis) for k, v in tree.items()}
    d = specs.dim_of("data")
    return tree if d is None else spmd.all_gather_dim(tree, d, axis)


def _row_specs(specs):
    """A stacked block's placements for one of its rows (the leading
    repeats axis dropped)."""
    if isinstance(specs, dict):
        return {k: _row_specs(v) for k, v in specs.items()}
    return spmd.Spec(*specs[1:])


def _check_tensor_parallel(cfg: ArchConfig, model: int) -> None:
    """Refuse a config the tensor-parallel forward cannot split over
    ``model`` ranks: attention heads, RWKV-6 heads or Mamba2 heads that
    the ``_COL`` rule would cut mid-head, and routed or shared expert
    columns that would stay whole (a block run whole on every rank)."""
    kinds = {b.kind for b in tuple(cfg.head_blocks) + tuple(cfg.pattern)
             + tuple(cfg.tail)}

    def refuse(n, what):
        raise NotImplementedError(f"{cfg.name}: {n} {what} do not split "
                                  f"over model={model} ranks")
    if kinds & {"dense", "attn_only", "moe"} and cfg.n_heads % model:
        refuse(cfg.n_heads, "attention heads")
    if "moe" in kinds:
        if cfg.d_ff_expert % model:
            refuse(cfg.d_ff_expert, "expert columns (d_ff_expert)")
        if cfg.n_shared_experts and cfg.d_ff_shared % model:
            refuse(cfg.d_ff_shared, "shared-expert columns (d_ff_shared)")
    if "mamba" in kinds:
        nh = cfg.d_inner // cfg.mamba_head_dim
        if nh % model:
            refuse(nh, "Mamba2 heads")
    if "rwkv" in kinds:
        H = cfg.d_model // cfg.rwkv_head_dim
        if cfg.d_model % model == 0 and H % model:
            refuse(H, "RWKV heads")


# =================================================================== specs
#
# The reference's placement rules (``repro/models/lm.py``), to the bit, as
# host logic over shapes and integer axis sizes: each function returns a
# tree mirroring its input whose leaves are ``spmd.Spec`` tuples (a mesh
# axis name, a tuple of names, or None per dimension; the reference's
# ``P()`` is ``Spec()``).

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_ck", "w_cr", "w_r", "w_k",
        "w_v", "w_g", "w_w", "w_z", "w_x"}    # (..., in, out): TP on out
_ROW = {"wo", "w_down", "w_out", "w_o", "w_cv"}  # (..., in, out): TP on in
_FSDP_ONLY = {"router", "w_bcdt"}


def _leaf_spec(name: str, shape, data: int, model: int,
               fsdp: bool = True) -> spmd.Spec:
    nd = len(shape)

    def ok(dim_idx, axis_size):
        return shape[dim_idx] % axis_size == 0

    if name == "embed":
        return spmd.Spec("model" if ok(0, model) else None, None)
    if name in _COL:
        sp = ["data" if fsdp and ok(nd - 2, data) else None,
              "model" if ok(nd - 1, model) else None]
    elif name in _ROW:
        sp = ["model" if ok(nd - 2, model) else None,
              "data" if fsdp and ok(nd - 1, data) else None]
    elif name in _FSDP_ONLY:
        sp = ["data" if fsdp and ok(nd - 2, data) else None, None]
    elif name == "conv":
        sp = [None, "model" if ok(nd - 1, model) else None]
    else:
        return spmd.Spec()
    return spmd.Spec(*([None] * (nd - 2) + sp))


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple / namedtuple
    (``path``: dict keys as strings, sequence indices as ints); a
    ``spmd.Spec`` is a leaf, None stays None."""
    if isinstance(tree, spmd.Spec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _leaf_name(path):
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return None


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its placement tree."""
    if isinstance(specs, spmd.Spec):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v, s) for v, s in zip(tree, specs))


def param_specs(params_shape, data: int, model: int, fsdp: bool = True):
    """Placement tree mirroring the params tree (rule-based on leaf name,
    the last dict key of its path).  ``data``/``model``: mesh axis sizes
    (for divisibility checks).  ``fsdp=False`` turns off the ZeRO-3
    ``"data"``-axis weight sharding (pure TP).  ``params_shape``: any tree
    whose leaves have ``.shape`` (:meth:`LM.param_shapes`)."""
    return map_with_path(
        lambda path, leaf: _leaf_spec(_leaf_name(path), tuple(leaf.shape),
                                      data, model, fsdp), params_shape)


def cache_specs(cache_shape, dp_axes: Tuple[str, ...], B: int, data: int,
                model: int, shard_seq: bool = False):
    """Placements for decode caches, the reference's rule as it is: a leaf
    of 3 or more dimensions splits its first over ``dp_axes`` and, for a
    4-D leaf longer than 4096 along its second (a KV cache), its heads (or
    head_dim) over ``"model"``, else its second over ``"model"``; a 2-D
    prev-token leaf its batch and its ``d``.  A stacked leaf's first
    dimension is its repeats axis, which the rule reads as the batch."""
    def f(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd >= 3:
            batch_ok = B % (data) == 0 and B >= data
            sp = [dp_axes if batch_ok and shape[0] % data == 0 else None]
            if nd == 4 and shape[1] > 4096:
                sp.append("data" if (shard_seq and not batch_ok and
                                     shape[1] % data == 0) else None)
                sp.append("model" if shape[2] % model == 0 else None)
                sp.append(None if shape[2] % model == 0 else
                          ("model" if shape[3] % model == 0 else None))
            else:
                sp.append("model" if shape[1] % model == 0 else None)
                sp += [None] * (nd - 2)
            return spmd.Spec(*sp)
        if nd == 2:
            return spmd.Spec(dp_axes if shape[0] % data == 0 and B >= data
                             else None,
                             "model" if shape[1] % model == 0 else None)
        return spmd.Spec()
    return map_with_path(f, cache_shape)


# ------------------------------------------------------- held layouts
#
# Where the tensor-parallel forward needs a leaf otherwise than the
# reference's placement puts it, the port holds it in the layout it
# computes with; the values are the reference's (docs/port.md lists every
# difference).


def held_param_specs(specs, cfg: ArchConfig, model: int):
    """The parameter layout the port holds: the reference's
    :func:`param_specs`, except ``wk`` / ``wv`` whole over ``"model"``
    where the kv heads do not split over it (each rank's query heads read
    their own kv heads, :func:`layers._local_heads`)."""
    if model == 1 or cfg.n_kv_heads % model == 0:
        return specs

    def f(path, spec):
        if _leaf_name(path) in ("wk", "wv"):
            return spmd.Spec(*(None if e == "model" else e for e in spec))
        return spec
    return map_with_path(f, specs)


def held_cache_specs(cache_shape, dp_axes, dp_size: int, B: int, data: int,
                     model: int):
    """The cache layout the port holds (:meth:`LM.init_cache` on a mesh):
    the batch over ``dp_axes`` where B splits over them (as the
    reference's ``training.serve._cache_specs``); a KV cache ``(B, S, KV,
    hd)`` its kv heads over ``"model"`` where they split, whole
    otherwise, never its sequence; an RWKV-6 state ``(B, H, hd, hd)`` and
    a Mamba2 scan state ``(B, nh, N, hd)`` their heads; the token shifts
    ``(B, d)`` whole along ``d``; a Mamba2 convolution state ``(B, dc-1,
    d_inner)`` its channels, as ``_cache_specs`` places it (the
    reference's :func:`cache_specs` would put ``"model"`` on ``dc-1``, 3,
    which does not split)."""
    batch_ok = B % dp_size == 0 and B >= dp_size
    bspec = dp_axes if batch_ok else None

    def f(path, leaf):
        stacked = "stack" in path
        shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
        name = _leaf_name(path)
        rest = [None] * (len(shape) - 1)
        if name == "kv":
            rest[1] = "model" if shape[2] % model == 0 else None
        elif name in ("state", "ssm"):
            rest[0] = "model" if shape[1] % model == 0 else None
        elif name == "conv":
            rest[1] = "model" if shape[2] % model == 0 else None
        sp = spmd.Spec(bspec, *rest)
        return spmd.Spec(None, *sp) if stacked else sp
    return map_with_path(f, cache_shape)
