"""PaliGemma-3B — SigLIP + Gemma backbone [arXiv:2407.07726].

The SigLIP vision tower is a STUB: input_specs() supplies 256 precomputed
patch embeddings at d_model; only the Gemma text backbone is modeled.
"""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256,
    pattern=(Block("dense", rope_theta=1e4),), act="gelu",
    prefix_len=256,
)
