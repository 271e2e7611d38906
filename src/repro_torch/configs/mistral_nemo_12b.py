"""Mistral-Nemo-12B — 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128,
    pattern=(Block("dense", rope_theta=1e6),), act="silu",
)
