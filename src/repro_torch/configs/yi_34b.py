"""Yi-34B [arXiv:2403.04652].

Llama-architecture GQA: 60 layers, d_model 7168, 56 heads kv=8, d_ff 20480
SwiGLU, vocab 64000, rope theta 5e6.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_variant="swiglu",
    rope_theta=5_000_000.0,
)
