"""Gemma3-27B — 5:1 local:global attention, 128k [hf:google/gemma-3-27b-pt]."""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128, qk_norm=True,
    # 5 sliding-window (1024) layers per full-attention layer; 62 = 10×6 + 2.
    pattern=(Block("dense", window=1024, rope_theta=1e4),) * 5
            + (Block("dense", rope_theta=1e6),),
    act="gelu",
)
