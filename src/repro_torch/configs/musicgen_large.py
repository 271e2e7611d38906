"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec tokenizer (and text-conditioning cross-attention) is a STUB:
input_specs() supplies precomputed audio-frame token ids (one codebook
stream, vocab 2048); only the transformer backbone is modeled.
"""
from .base import ArchConfig, Block

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=2048, head_dim=64,
    pattern=(Block("dense", rope_theta=1e4),), act="gelu", gated_ffn=False,
)
