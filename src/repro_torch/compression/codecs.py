"""The built-in wire formats (the counterpart of
``repro.compression.codecs``): none, bf16, int8 (stochastic rounding,
per-chunk scales), top-k sparsification (error feedback).

Every codec works on ``[N, n]`` float buffers with clients as rows, so the
compression granularity (chunk scales, top-k selection) is always
per-client.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compression.base import Codec, register


@dataclass(frozen=True)
class NoneCodec(Codec):
    """Identity wire format: 32 bits/param, nothing lost. Engines strip it
    (``compression.active`` -> None)."""

    name = "none"
    is_identity = True

    def bits_per_param(self) -> float:
        return 32.0

    def encode(self, x, *, u=None):
        return x

    def decode(self, enc, shape):
        return enc.to(torch.float32)


@dataclass(frozen=True)
class BF16Codec(Codec):
    """Round-to-nearest bfloat16 on the wire: 16 bits/param, no side
    information."""

    name = "bf16"

    def bits_per_param(self) -> float:
        return 16.0

    def encode(self, x, *, u=None):
        return x.to(torch.bfloat16)

    def decode(self, enc, shape):
        return enc.to(torch.float32)


class Int8Encoded(NamedTuple):
    """int8 wire record. ``values`` is padded to a whole number of chunks
    ([N, ceil(n/chunk)*chunk]) — the layout the ``fed_mix_q`` kernel
    consumes without re-packing."""
    values: torch.Tensor     # int8 [N, n_pad]
    scales: torch.Tensor     # f32  [N, n_pad // chunk]


#: 1/127 as the JAX engines compute the scale: under jit XLA rewrites the
#: divide by the constant 127 as a multiply by its f32 reciprocal
_INV_127 = 1.0 / 127.0


@dataclass(frozen=True)
class Int8Codec(Codec):
    """Symmetric int8 with one float32 scale per ``chunk`` consecutive
    params (absmax / 127). With noise ``u`` ~ U[0, 1) (shape [N, n_pad])
    the quantizer rounds stochastically (``floor(x/s + u)``), unbiased
    across rounds; with ``u=None`` it rounds to nearest, half to even as
    ``jnp.round`` does. bits/param = 8 + 32/chunk."""

    chunk: int = 256

    name = "int8"

    def bits_per_param(self) -> float:
        return 8.0 + 32.0 / self.chunk

    def padded(self, n: int) -> int:
        """n rounded up to a whole number of chunks: the record's width."""
        return n + (-n) % self.chunk

    def encode(self, x, *, u=None):
        x = x.to(torch.float32)
        xc = F.pad(x, (0, self.padded(x.shape[1]) - x.shape[1])).reshape(
            x.shape[0], -1, self.chunk)
        scale = xc.abs().amax(dim=-1) * _INV_127                # [N, nc]
        scale = torch.clamp_min(scale, 1e-12)                   # dead chunks
        y = xc / scale[..., None]
        if u is None:
            y = torch.round(y)
        else:
            y = torch.floor(y + u.reshape(y.shape))
        q = torch.clamp(y, -127, 127).to(torch.int8)
        return Int8Encoded(values=q.reshape(q.shape[0], -1), scales=scale)

    def decode(self, enc: Int8Encoded, shape: Tuple[int, int]):
        n = shape[1]
        v = enc.values.to(torch.float32).reshape(
            enc.values.shape[0], -1, self.chunk)
        return (v * enc.scales[..., None]).reshape(
            enc.values.shape[0], -1)[:, :n]


class TopKEncoded(NamedTuple):
    values: torch.Tensor     # f32   [N, k]
    indices: torch.Tensor    # int64 [N, k]


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Keep each client's ``density`` fraction of largest-magnitude entries
    (value + index on the wire: 64 * density bits/param). Deterministic and
    ``stateful``: the dropped mass is carried as an error-feedback residual
    by the engine. Under ties of |x| ``torch.topk`` may keep other entries
    than ``jax.lax.top_k``."""

    density: float = 0.05

    name = "topk"
    stateful = True

    def bits_per_param(self) -> float:
        return 64.0 * self.density

    def _k(self, n: int) -> int:
        return max(1, min(n, int(-(-n * self.density // 1))))    # ceil

    def encode(self, x, *, u: Optional[torch.Tensor] = None):
        xf = x.to(torch.float32)
        idx = torch.topk(xf.abs(), self._k(xf.shape[1]), dim=1).indices
        return TopKEncoded(values=torch.gather(xf, 1, idx), indices=idx)

    def decode(self, enc: TopKEncoded, shape: Tuple[int, int]):
        out = torch.zeros(shape, dtype=torch.float32,
                          device=enc.values.device)
        return out.scatter_(1, enc.indices, enc.values)


register(NoneCodec())
register(BF16Codec())
register(Int8Codec())
register(TopKCodec())
