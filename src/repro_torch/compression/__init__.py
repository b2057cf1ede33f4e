"""repro_torch.compression — the quantized-exchange codec registry (the
counterpart of ``repro.compression``).

    codec = compression.get("int8")
    enc = codec.encode(flat, u=noise)           # after kernels.ops.pack_tree
    flat_hat = codec.decode(enc, flat.shape)    # before unpack_tree
    bits = codec.bits_per_param()               # §3.2 wire width

Registered: ``none`` (32b identity), ``bf16`` (16b truncation), ``int8``
(8.125b: stochastic rounding, per-chunk absmax scales), ``topk`` (64·density
bits: magnitude sparsification + error feedback). The JAX codecs take a
PRNG key; these take the uniform noise ``u`` itself (``None`` = round to
nearest), which the engines draw (``RoundDraws.wire_noise``,
``MeshDraws.wire_noise``). The mesh path's per-leaf wire is
``wire_tree`` / ``feedback_wire_tree`` (one noise buffer a leaf, where the
JAX package folds the leaf's index into its key) with
``init_feedback_state``.
"""
from repro_torch.compression.base import (  # noqa: F401
    Codec, active, as_codec, feedback_encode, feedback_wire_tree, get,
    init_feedback_state, names, register, transmit, wire_tree,
)
from repro_torch.compression.codecs import (  # noqa: F401
    BF16Codec, Int8Codec, Int8Encoded, NoneCodec, TopKCodec, TopKEncoded,
)
