"""Qwen2-1.5B [arXiv:2407.10671].

28 layers, d_model 1536, 12 heads GQA kv=2, d_ff 8960 SwiGLU, vocab 151936,
QKV bias, tied embeddings, rope theta 1e6.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
