"""The lossy-exchange ``Codec`` interface + registry (the counterpart of
``repro.compression.base``).

A ``Codec`` describes what one client puts on the wire each round:

  * ``encode(x, u=...)`` — lossy-compress a ``[N, n]`` float buffer (N
    clients, n params per client) into the codec's wire record; ``u`` is
    the uniform noise of stochastic rounding (``None`` = deterministic),
  * ``decode(enc, shape)`` — the float32 buffer the receivers integrate,
  * ``bits_per_param()`` — the §3.2 cost-model width, side information
    included, against the 32-bit baseline.

What crosses the wire is always a round DELTA ``f_new - f_old`` against the
round-start state the receivers hold, never raw parameters (``transmit``).
Stateful codecs (error feedback) set ``stateful = True`` and the engine
carries their residual across rounds; the codec itself stays a pure value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class Codec:
    """Abstract lossy wire format. Subclass + ``register`` to add one.
    ``encode``/``decode`` work on 2-D ``[N, n]`` buffers, clients as rows,
    and the same ``(x, u)`` always encodes the same record."""

    #: registry key, e.g. "int8"
    name = ""
    #: True -> the exchange carries an error-feedback residual the engine
    #: threads across rounds
    stateful = False
    #: True -> encode/decode are the identity; engines strip the codec so
    #: the no-compression path runs the codec-free program
    is_identity = False

    def bits_per_param(self) -> float:
        """Wire bits per parameter, side information included (32 = none)."""
        raise NotImplementedError

    def encode(self, x: torch.Tensor, *, u: Optional[torch.Tensor] = None):
        """[N, n] float buffer -> wire record."""
        raise NotImplementedError

    def decode(self, enc, shape: Tuple[int, int]) -> torch.Tensor:
        """Wire record -> [N, n] float32 reconstruction (``shape`` is the
        original buffer shape — sparse/padded records need it)."""
        raise NotImplementedError

    def roundtrip(self, x: torch.Tensor, *,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode(encode(x)) — what the receivers see, as float32."""
        return self.decode(self.encode(x, u=u), tuple(x.shape))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Codec] = {}

CodecLike = Union[None, str, Codec]


def register(codec: Codec) -> Codec:
    """Register a Codec instance under ``codec.name``."""
    if not codec.name:
        raise ValueError("codec must define a non-empty .name")
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} is already registered")
    _REGISTRY[codec.name] = codec
    return codec


def names() -> Tuple[str, ...]:
    """Registered codec names, in registration order."""
    return tuple(_REGISTRY)


def get(name: str) -> Codec:
    """Look up a registered codec; unknown names raise (never a silent
    full-precision fallback)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered codecs: "
            f"{', '.join(names())}") from None


def as_codec(codec: CodecLike) -> Codec:
    """Normalize None | name | Codec to a Codec instance (None -> 'none')."""
    if codec is None:
        return get("none")
    if isinstance(codec, str):
        return get(codec)
    return codec


def active(codec: CodecLike) -> Optional[Codec]:
    """Like ``as_codec`` but maps identity codecs to ``None`` — the form the
    engine branches on, so ``codec='none'`` runs the codec-free program."""
    c = as_codec(codec)
    return None if c.is_identity else c


# ---------------------------------------------------------------------------
# Exchange helpers
# ---------------------------------------------------------------------------

def feedback_encode(codec: Codec, delta: torch.Tensor, residual=None, *,
                    u: Optional[torch.Tensor] = None):
    """The error-feedback wire algebra: add the carried residual, encode,
    and split off the new compression error. Returns ``(enc, shape,
    new_residual)`` — the wire record, the buffer shape ``decode`` needs,
    and ``(delta + residual) - decode(enc)`` for stateful codecs (``None``
    otherwise)."""
    df = delta.to(torch.float32)
    if residual is not None:
        df = df + residual
    enc = codec.encode(df, u=u)
    shape = tuple(df.shape)
    new_residual = (df - codec.decode(enc, shape)) if codec.stateful \
        else None
    return enc, shape, new_residual


def transmit(codec: Codec, delta: torch.Tensor, residual=None, *,
             u: Optional[torch.Tensor] = None):
    """One lossy wire exchange of a ``[N, n]`` round-delta buffer with
    optional error feedback. Returns ``(delta_hat, new_residual)``: the
    float32 reconstruction the receivers add to their base, and the
    compression error to carry into the next round (``None`` for
    stateless codecs)."""
    enc, shape, new_residual = feedback_encode(codec, delta, residual, u=u)
    return codec.decode(enc, shape), new_residual
