"""Qwen3-32B — qk_norm, GQA [hf:Qwen/Qwen3-32B]."""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True,
    pattern=(Block("dense", rope_theta=1e6),), act="silu",
)
