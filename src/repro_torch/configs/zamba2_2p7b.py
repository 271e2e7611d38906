"""Zamba2-2.7B — Mamba2 backbone with shared attention blocks [arXiv:2411.15242]."""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, ssm_state=64, mamba_head_dim=64,
    # 5 Mamba2 blocks then one SHARED full-attention block, ×9 = 54 layers.
    pattern=(Block("mamba"),) * 5 + (Block("attn_only", shared=True),),
    act="silu", subquadratic=True,
)
