"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head architecture: every layer runs attention heads and Mamba(-2
style) SSM heads IN PARALLEL on the same input and mean-combines the two
normalized branch outputs. 32 layers, d_model 1600, 25 attention heads GQA
kv=5, d_ff 5504, ssm_state 16, vocab 32001, 128 learnable meta tokens
prepended to the sequence, sliding-window attention in most layers with
full-attention global layers interleaved.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp_variant="swiglu",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    num_meta_tokens=128,
    sliding_window=1024,
    global_layer_every=16,    # layers 0, 16 are full-attention
)
