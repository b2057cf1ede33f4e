"""Gemma 2B [arXiv:2403.08295].

18 layers, d_model 2048, 8 heads with MQA (kv=1), head_dim 256, d_ff 16384
GeGLU, vocab 256000, embedding scaling by sqrt(d_model), RMSNorm(1+w),
tied embeddings.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="geglu",
    norm_type="rmsnorm_p1",
    embed_scale=True,
    tie_embeddings=True,
)
