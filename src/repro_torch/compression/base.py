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

Where the codec sits: the one-card paths quantize the packed ``[D,
sum(sizes)]`` round-delta buffer (``kernels.ops.wire_flat``); the mesh
path wraps each ``[D, ...]`` leaf in a round trip before the collectives
(``wire_tree`` / ``feedback_wire_tree``). Rows are clients on both, so
chunk scales and top-k selections are per client.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

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


# ---------------------------------------------------------------------------
# The per-leaf wire of the mesh path
# ---------------------------------------------------------------------------

def _leaf_u(u: Optional[Sequence[torch.Tensor]], i: int):
    """Leaf i's rounding noise: the JAX package's ``fold_in(key, i)``
    becomes one noise buffer a leaf."""
    return None if u is None else u[i]


def _leaf2d(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0], -1).to(torch.float32)


def _leaves(tree):
    # kernels.ops imports this package: imported at call time
    from repro_torch.kernels.ops import tree_flatten
    return tree_flatten(tree)


def wire_tree(codec: Codec, f_new, f_old, *,
              u: Optional[Sequence[torch.Tensor]] = None):
    """Stateless per-leaf wire: every f_new leaf becomes ``f_old +
    roundtrip(f_new - f_old)``, what the receivers hold after the senders
    upload their compressed round deltas. Leaves are flattened to [N,
    size] (chunks never cross leaves) and cast back to their own dtypes.
    ``u``: one noise buffer a leaf ([N, padded size] for int8), in leaf
    order; None rounds to nearest."""
    from repro_torch.kernels.ops import tree_unflatten
    new_leaves, treedef = _leaves(f_new)
    old_leaves = _leaves(f_old)[0]
    out = []
    for i, (new, old) in enumerate(zip(new_leaves, old_leaves)):
        base = _leaf2d(old)
        d_hat, _ = transmit(codec, _leaf2d(new) - base, u=_leaf_u(u, i))
        out.append((base + d_hat).reshape(new.shape).to(new.dtype))
    return tree_unflatten(treedef, out)


def feedback_wire_tree(codec: Codec, f_new, f_old, state, *,
                       u: Optional[Sequence[torch.Tensor]] = None):
    """Per-leaf error-feedback wire for stateful codecs: returns
    ``(tree_tx, new_state)``, the post-wire leaves (their own dtypes) and
    the f32 residual tree (the same structure, leaves [N, size])."""
    from repro_torch.kernels.ops import tree_unflatten
    new_leaves, treedef = _leaves(f_new)
    old_leaves = _leaves(f_old)[0]
    res_leaves = _leaves(state)[0]
    tx, new_res = [], []
    for i, (new, old, res) in enumerate(zip(new_leaves, old_leaves,
                                            res_leaves)):
        base = _leaf2d(old)
        d_hat, r = transmit(codec, _leaf2d(new) - base, res,
                            u=_leaf_u(u, i))
        tx.append((base + d_hat).reshape(new.shape).to(new.dtype))
        new_res.append(r)
    return tree_unflatten(treedef, tx), tree_unflatten(treedef, new_res)


def init_feedback_state(codec: Optional[Codec], tree):
    """Zero error-feedback residuals for a stacked tree (leaves [N, ...]):
    leaves [N, size] f32; ``None`` when the codec carries no state."""
    if codec is None or not codec.stateful:
        return None
    from repro_torch.kernels.ops import tree_unflatten
    leaves, treedef = _leaves(tree)
    return tree_unflatten(treedef, [
        torch.zeros((leaf.shape[0], leaf[0].numel()), dtype=torch.float32,
                    device=leaf.device) for leaf in leaves])
