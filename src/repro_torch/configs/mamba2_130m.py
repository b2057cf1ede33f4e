"""Mamba2-130M [arXiv:2405.21060].

Attention-free SSD (state-space duality): 24 layers, d_model 768,
expand 2 (d_inner 1536), head_dim 64 (24 SSM heads), state 128,
conv width 4, vocab 50280, tied embeddings.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,            # attention-free
    d_ff=0,                 # no MLP block; the SSD mixer includes the gating
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
