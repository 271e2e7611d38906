"""Architecture config system: ArchConfig, input shapes, registry.

Counterpart of ``repro/configs/base.py`` (a copy: the reference's module
imports ``jax`` at the top; ``input_specs`` gives ``"meta"`` tensors where
the reference gives ``jax.ShapeDtypeStruct``).  Every assigned
architecture is a ``configs/<id>.py`` exporting ``CONFIG``; those data
files are copied verbatim.  Backbones are built from a repeating
``pattern`` of Blocks, plus optional unrolled ``head_blocks`` (before) and
an automatic tail (the ``n_layers % len(pattern)`` remainder, taken from
the pattern prefix).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str                      # dense | moe | mamba | rwkv | attn_only
    window: Optional[int] = None   # sliding-window size for this block's attn
    rope_theta: float = 1e4
    shared: bool = False           # share params across repeats (zamba2 attn)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    pattern: Tuple[Block, ...]
    head_blocks: Tuple[Block, ...] = ()
    act: str = "silu"
    gated_ffn: bool = True
    qk_norm: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    # ssm
    ssm_state: int = 0
    mamba_head_dim: int = 64
    rwkv_head_dim: int = 64
    # performance knobs (§Perf hillclimb variants; defaults = baseline)
    moe_dispatch: str = "scatter"  # 'scatter' | 'gather' (see models.moe)
    remat_group: int = 1           # layers per remat group in the train scan
    # io / modality
    prefix_len: int = 0            # stubbed frontend embeddings (vlm)
    subquadratic: bool = False     # eligible for long_500k
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # activation replacement mode when masked: 'identity' | 'poly2'
    act_when_masked: str = "identity"

    @property
    def n_repeats(self) -> int:
        return (self.n_layers - len(self.head_blocks)) // len(self.pattern)

    @property
    def tail(self) -> Tuple[Block, ...]:
        rem = (self.n_layers - len(self.head_blocks)) % len(self.pattern)
        return self.pattern[:rem]

    @property
    def d_inner(self) -> int:      # mamba inner width
        return 2 * self.d_model

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU tests."""
        pat = self.pattern
        nl = len(self.head_blocks) + 2 * len(pat) + len(self.tail)
        return dataclasses.replace(
            self, n_layers=nl, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2), head_dim=16,
            d_ff=96, vocab=128,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=32 if self.n_experts else 0,
            d_ff_shared=32 if self.n_shared_experts else 0,
            ssm_state=8 if self.ssm_state else 0,
            mamba_head_dim=16, rwkv_head_dim=16,
            prefix_len=8 if self.prefix_len else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "zamba2_2p7b", "stablelm_1p6b", "mistral_nemo_12b", "qwen3_32b",
    "gemma3_27b", "mixtral_8x22b", "deepseek_moe_16b", "rwkv6_3b",
    "paligemma_3b", "musicgen_large",
]


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def cell_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 512k decode is quadratic"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeCell):
    """``"meta"`` tensor stand-ins for every model input (no allocation):
    the reference's names and shapes.  Tokens are int32 (the LM's
    embedding takes any integer tensor; the serving and training paths
    hand it int32, as the reference's), embeddings the config's dtype.

    train:   tokens/labels (B, S) (+ prefix_embeds for stub frontends;
             text length shrinks so total seq == shape.seq_len)
    prefill: tokens (B, S)
    decode:  token (B, 1) + cache handled by the step factory.
    """
    import torch
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    text = S - cfg.prefix_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    specs = {}
    if shape.mode == "train":
        specs["tokens"] = meta((B, text), i32)
        specs["labels"] = meta((B, text), i32)
    elif shape.mode == "prefill":
        specs["tokens"] = meta((B, text), i32)
    else:  # decode: one new token, cache of length S
        specs["tokens"] = meta((B, 1), i32)
    if cfg.prefix_len and shape.mode != "decode":
        specs["prefix_embeds"] = meta((B, cfg.prefix_len, cfg.d_model), f)
    return specs


def make_inputs(cfg: ArchConfig, shape: ShapeCell, seed: int = 0,
                device="cuda"):
    """Concrete (small-RNG) inputs matching :func:`input_specs`, on
    ``device``: the reference's numpy stream, so its tokens are equal and
    its embeddings bit-equal.  The float64 normals are rounded to float32
    first and then to bfloat16, as ``jnp.asarray(..., dtype=bfloat16)``
    rounds them (twice, not once)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            a = torch.from_numpy(rng.integers(0, cfg.vocab, size=spec.shape,
                                              dtype=np.int32))
        else:
            a = torch.from_numpy((rng.normal(size=spec.shape) * 0.02)
                                 .astype(np.float32)).to(spec.dtype)
        out[k] = a.to(device)
    return out
