"""DeepSeekMoE-16B — 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066].

Layer 0 is a dense FFN (d_ff 10944) per the released config; layers 1..27 MoE.
"""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, head_dim=128,
    n_experts=64, top_k=6, d_ff_expert=1408,
    n_shared_experts=2, d_ff_shared=2816,
    head_blocks=(Block("dense"),),
    pattern=(Block("moe"),), act="silu",
)
