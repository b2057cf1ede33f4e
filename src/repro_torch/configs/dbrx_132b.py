"""DBRX 132B [hf:databricks/dbrx-base].

40 layers, d_model 6144, 48 heads GQA kv=8, fine-grained MoE: 16 experts
top-4, per-expert d_ff 10752 (SwiGLU), vocab 100352.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    moe_d_ff=10752,
    vocab_size=100352,
    mlp_variant="swiglu",
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500_000.0,
    norm_type="layernorm",
)
