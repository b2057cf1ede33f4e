"""Chameleon-34B [arXiv:2405.09818].

Early-fusion mixed-modal decoder: 48 layers, d_model 8192, 64 heads GQA kv=8,
d_ff 22016 SwiGLU, unified vocab 65536 (text + VQ image tokens), qk-norm
(the stability fix the paper introduces for mixed-modal training).

Frontend STUB: the VQ-GAN image tokenizer is not implemented; input_specs()
provides mixed token ids where a fraction of the sequence is image tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    mlp_variant="swiglu",
    qk_norm=True,
    image_token_frac=0.5,
)
