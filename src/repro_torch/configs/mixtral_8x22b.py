"""Mixtral-8x22B — 8 experts top-2, SWA [arXiv:2401.04088]."""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128,
    n_experts=8, top_k=2, d_ff_expert=16384,
    pattern=(Block("moe", window=4096, rope_theta=1e6),), act="silu",
)
