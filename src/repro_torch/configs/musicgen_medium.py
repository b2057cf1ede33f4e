"""MusicGen-medium [arXiv:2306.05284].

Decoder-only transformer over EnCodec residual-VQ tokens: 48 layers, d_model
1536, 24 heads MHA (kv=24), d_ff 6144 (GELU), 4 codebooks x vocab 2048 with
delay interleaving, cross-attention to text-conditioning embeddings.

Frontend STUB: input_specs() provides precomputed frame embeddings (the sum
of the 4 codebook embeddings) plus the T5 conditioning context; this module
is the decoder backbone only (per the brief's audio carve-out).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_variant="gelu",
    norm_type="layernorm",
    num_codebooks=4,
    cross_attend=True,
    cross_context_len=64,
    cross_context_dim=1536,
)
