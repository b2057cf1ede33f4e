"""DeepSeek-V2 236B [arXiv:2405.04434].

60 layers, d_model 5120, 128 heads with Multi-head Latent Attention
(kv_lora_rank 512, q_lora_rank 1536, qk nope 128 + rope 64, v 128),
MoE with 2 shared + 160 routed experts top-6, per-expert d_ff 1536,
first layer dense (d_ff 12288), vocab 102400.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,         # MLA: all heads read the shared latent cache
    head_dim=192,             # qk nope 128 + rope 64
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=102400,
    mlp_variant="swiglu",
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    moe_dense_d_ff=12288,
)
