"""Nemotron-4 15B [arXiv:2402.16819].

32 layers, d_model 6144, 48 query heads with GQA kv=8, d_ff 24576 with
squared-ReLU MLP (no gating), vocab 256000, partial rotary (50%), no bias.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_variant="squared_relu",
    rope_pct=0.5,
    rope_theta=10000.0,
    norm_type="layernorm",
    tie_embeddings=False,
)
