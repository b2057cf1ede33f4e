"""Placement on the mesh: what stands in for the JAX package's
``device_put`` / ``jit(out_shardings=...)``.

Each rank holds the slice of every leaf that its spec gives it
(``sharding/rules.py``): a dim split over axes ``(a, b)`` is cut into
``|a| * |b|`` equal blocks, and the rank keeps the block at its row-major
index over ``(a, b)``.

* ``local_shards`` / ``gather_shards``: whole tree -> this rank's slices,
  and back (an ``all_gather`` per split dim);
* ``init_local_params``: the port's seeded init (``transformer
  .init_params``) replayed draw for draw, each leaf cut to this rank's
  slice as it is drawn, so the slices equal the one-device init bit for
  bit and no rank ever holds more than one layer (or the embeddings)
  whole; the ranks of a mesh draw one after another (``in_turn``), so at
  most one rank's whole leaf exists at a time;
* ``init_local_cache``: a serving cache placed by ``make_cache_specs``;
* ``reshard``: one layout to another (train -> decode: an all-gather over
  the data axes, then this rank's slice of the new layout);
* ``for_use``: a leaf in the form the layers compute with: gathered over
  every axis except the model axis on the dim a layer splits itself
  (heads, hidden units, experts, vocabulary): FSDP under ``tp``, ZeRO-3
  under ``seqtp`` / ``dp``, layer by layer;
* ``local_rows``: this rank's rows of a batch.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import (
    SPLIT_KEYS, MeshInfo, Spec, make_cache_specs, make_param_specs,
    tree_paths,
)


def _map(fn, tree: Dict, specs: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = (_map(fn, v, specs[k], path) if isinstance(v, dict)
                  else fn(path, v, specs[k]))
    return out


def local_shape(shape: Sequence[int], spec: Spec, info: MeshInfo
                ) -> Tuple[int, ...]:
    out = []
    for n, axes in zip(shape, spec):
        k = info.size(axes)
        if n % k:
            raise ValueError(f"a dim of {n} does not split over {axes} "
                             f"({k} ranks)")
        out.append(n // k)
    return tuple(out) + tuple(shape[len(spec):])


def local_slice(t: torch.Tensor, spec: Spec, info: MeshInfo
                ) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    for dim, axes in enumerate(spec):
        k = info.size(axes)
        if k == 1:
            continue
        if t.shape[dim] % k:
            raise ValueError(f"a dim of {t.shape[dim]} does not split over "
                             f"{axes} ({k} ranks)")
        n = t.shape[dim] // k
        t = t.narrow(dim, info.index(axes) * n, n)
    return t


#: the most bytes one gather moves: gloo stages CUDA tensors through
#: pinned host buffers that it keeps by size class, so a leaf of GBs (an
#: embedding table, a stack of layers) goes in pieces of at most this
GATHER_BYTES = 1 << 28


def gather_leaf(t: torch.Tensor, spec: Spec, info: MeshInfo,
                keep: Optional[Spec] = None) -> torch.Tensor:
    """``t`` (this rank's block under ``spec``) gathered over every split
    dim whose axes differ from ``keep``'s at that dim (None: every split
    dim): the leaf under the spec ``keep``. A leaf of more than
    GATHER_BYTES is gathered in pieces along its first dim not gathered."""
    dims = [d for d, axes in enumerate(spec)
            if axes and not (keep is not None and keep[d] == axes)]
    whole = list(t.shape)
    for d in dims:
        whole[d] *= info.size(spec[d])
    free = [d for d in range(t.dim()) if d not in dims and t.shape[d] > 1]
    nbytes = math.prod(whole) * t.element_size()
    if nbytes <= GATHER_BYTES or not free:
        for d in dims:
            t = info.all_gather(t, d, spec[d])
        return t
    d0 = free[0]
    step = -(-t.shape[d0] * GATHER_BYTES // nbytes) or 1
    out = t.new_empty(whole)
    for lo in range(0, t.shape[d0], step):
        part = t.narrow(d0, lo, min(step, t.shape[d0] - lo))
        for d in dims:
            part = info.all_gather(part, d, spec[d])
        out.narrow(d0, lo, part.shape[d0]).copy_(part)
    return out


def local_shards(tree: Dict, specs: Dict, info: MeshInfo) -> Dict:
    """Whole leaves -> this rank's blocks (contiguous copies; a leaf that
    is not a tensor is kept as it is)."""
    return _map(lambda path, t, spec: (
        local_slice(t, spec, info).contiguous().clone()
        if isinstance(t, torch.Tensor) else t), tree, specs)


def gather_shards(tree: Dict, specs: Dict, info: MeshInfo) -> Dict:
    """This rank's blocks -> whole leaves, on every rank."""
    return _map(lambda path, t, spec: (
        gather_leaf(t, spec, info) if isinstance(t, torch.Tensor) else t),
        tree, specs)


def reshard(tree: Dict, src: Dict, dst: Dict, info: MeshInfo,
            release: bool = False) -> Dict:
    """Blocks under the specs ``src`` -> blocks under ``dst``: each dim
    whose axes differ is gathered, then cut as ``dst`` says (train ->
    decode: an all-gather over the data axes), a stack of layers one
    layer at a time. With ``release`` each leaf is dropped from ``tree``
    (which ends empty) once its new block exists, the largest first: the
    peak is then the new layout plus the smallest leaves' old blocks, not
    plus the largest's."""
    size = {path: _nbytes(v) for path, v in tree_paths(tree)}
    paths = list(size)
    src_at, dst_at = dict(tree_paths(src)), dict(tree_paths(dst))
    new = {}
    # every rank's blocks have the same sizes, and the sort is stable:
    # the ranks' collectives run in one order
    for path in sorted(paths, key=lambda q: -size[q]):
        *head, last = path.split("/")
        parent = tree
        for k in head:
            parent = parent[k]
        v = parent[last]
        if src_at[path] != dst_at[path] and isinstance(v, torch.Tensor):
            v = _reshard_leaf(v, src_at[path], dst_at[path], info)
        new[path] = v
        if release:
            del parent[last]
    out: Dict = {}
    for path in paths:                       # the tree's own key order
        *head, last = path.split("/")
        t = out
        for k in head:
            t = t.setdefault(k, {})
        t[last] = new[path]
    if release:
        _prune(tree)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _prune(tree: Dict) -> None:
    """Drop the subtrees ``reshard`` emptied."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _prune(tree[k])
            if not tree[k]:
                del tree[k]


def _reshard_leaf(v: torch.Tensor, src: Spec, dst: Spec, info: MeshInfo
                  ) -> torch.Tensor:
    if (v.dim() > 1 and not src[0] and not dst[0]
            and v.numel() * v.element_size() > GATHER_BYTES):
        first = _reshard_leaf(v[0], src[1:], dst[1:], info)
        out = first.new_empty((v.shape[0],) + tuple(first.shape))
        out[0] = first
        for i in range(1, v.shape[0]):
            out[i] = _reshard_leaf(v[i], src[1:], dst[1:], info)
        return out
    keep = tuple(a if a == b else () for a, b in zip(src, dst))
    whole = gather_leaf(v, src, info, keep=keep)
    cut = tuple(b if a != b else () for a, b in zip(src, dst))
    return local_slice(whole, cut, info).contiguous()


def shard_bytes(tree: Dict) -> int:
    """Bytes of the tensors of ``tree``."""
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# The form the layers compute with
# ---------------------------------------------------------------------------

_TP_OWN = {  # (path part, leaf name) -> the dim (after L) a layer splits
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0,
             "w_uq": 1, "w_uk": 1, "w_uv": 1},
    "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0},
    "mlp": {"w_in": 1, "w_gate": 1, "w_out": 0, "b_in": 0},
    "shared": {"w_in": 1, "w_gate": 1, "w_out": 0, "b_in": 0},
    "moe": {"w_in": 0, "w_gate": 0, "w_out": 0},
}


def vocab_dim(path: str) -> Optional[int]:
    """The vocabulary's dim of an embedding table (0), an unembedding or
    the audio heads (1); None for any other leaf."""
    if path.endswith("embed/table"):
        return 0
    if (path.endswith("embed/unembed") or path.endswith("/heads")
            or path == "heads"):
        return 1
    return None


def own_dim(path: str, info: MeshInfo) -> Optional[int]:
    """The dim of a leaf at ``path`` (layer paths without their L dim)
    that the layers split over the model axis themselves, or None: the
    vocabulary of the embeddings under every strategy; heads, hidden
    units and experts under ``tp``."""
    if vocab_dim(path) is not None:
        return vocab_dim(path)
    if info.strategy != "tp":
        return None
    parts = path.split("/")
    name = parts[-1]
    for part in reversed(parts[:-1]):
        if part in _TP_OWN:
            return _TP_OWN[part].get(name)
    return None


def use_spec(path: str, spec: Spec, info: MeshInfo) -> Spec:
    """The spec a leaf has when a layer computes with it: the model axis
    alone on the dim the layer splits (``own_dim``), every other dim
    whole."""
    dim = own_dim(path, info)
    return tuple(a if (i == dim and a == (info.tp_axis,)) else ()
                 for i, a in enumerate(spec))


# weights the layers only ever apply as ``x @ w``
_MATMUL = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "in_proj",
           "out_proj", "router", "w_dq", "w_dkv", "w_kr")


class SplitWeight:
    """A 2-D weight left as this rank's block along one dim over the model
    axis and applied as ``x @ w`` without gathering it (the decode
    layout's weight-stationary form): split along its output dim, the
    block's columns are computed and all-gathered; along its input dim,
    the block's rows take x's matching slice and the partial products are
    all-reduced. ``shape`` is the whole weight's."""

    def __init__(self, block: torch.Tensor, dim: int, axes, info: MeshInfo):
        self.block, self.dim, self.axes, self.info = block, dim, axes, info
        shape = list(block.shape)
        shape[dim] *= info.size(axes)
        self.shape = torch.Size(shape)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim == 1:
            return self.info.all_gather(x @ self.block, x.dim() - 1,
                                        self.axes)
        n = self.block.shape[0]
        part = x.narrow(-1, self.info.index(self.axes) * n, n) @ self.block
        return self.info.all_reduce(part, self.axes)


class StationaryTable:
    """An embedding table [V, d] (or an unembedding / the audio heads
    [d, V]) left as this rank's block at a decode step, where its dims
    are split over axes the batch's rows are split over too (FSDP): the
    step gathers the tokens or hidden states of every row (a few KB), not
    the table (GBs). ``spec`` is the block's (vocab over ``model`` where
    it divides, d over the data axes)."""

    def __init__(self, block: torch.Tensor, spec: Spec, info: MeshInfo,
                 vocab_dim: int):
        self.block, self.spec, self.info = block, spec, info
        self.vocab_dim = vocab_dim

    def _rows(self):
        from repro_torch.sharding.context import activation_spec
        rule = activation_spec("act_btd")
        return rule[0] if rule else ()

    def _d_block(self):
        axes = self.spec[1 - self.vocab_dim]
        n = self.block.shape[1 - self.vocab_dim]
        return axes, (self.info.index(axes) * n if axes else 0), n

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of ``tokens`` (this rank's rows of the batch)."""
        info, rows = self.info, self._rows()
        every = info.all_gather(tokens, 0, rows) if rows else tokens
        va = self.spec[0]
        nv = self.block.shape[0]
        ids = every.long() - (info.index(va) * nv if va else 0)
        mine = (ids >= 0) & (ids < nv)
        x = self.block[ids.clamp(0, nv - 1)] * mine[..., None].to(
            self.block.dtype)
        if va:
            x = info.all_reduce(x, va)
        da, _, _ = self._d_block()
        if da:
            x = info.all_gather(x, x.dim() - 1, da)
        b = tokens.shape[0]
        return x.narrow(0, info.index(rows) * b, b) if rows else x

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ w`` ([d, V] weights) or ``h @ table.T`` ([V, d] table) on
        this rank's rows: this rank's block of the vocabulary."""
        info, rows = self.info, self._rows()
        every = info.all_gather(h, 0, rows) if rows else h
        da, lo, n = self._d_block()
        part = every.narrow(-1, lo, n)
        out = part @ (self.block if self.vocab_dim == 1 else self.block.T)
        if da:
            out = info.all_reduce(out, da)
        b = h.shape[0]
        return out.narrow(0, info.index(rows) * b, b) if rows else out


def for_use(tree: Dict, specs: Dict, info: MeshInfo, prefix: str,
            stationary: bool = False) -> Dict:
    """``tree`` (blocks at ``prefix``, one layer's when ``prefix`` names
    a stacked subtree: its leaves without their L dim, ``specs`` with it)
    gathered into the form the layers compute with (``use_spec``). With
    ``stationary`` (a decode step), a weight applied as ``x @ w`` and
    split along one dim over the model axis alone stays split
    (``SplitWeight``): the step moves activations, not weights."""
    stacked = prefix.split("/", 1)[0] in SPLIT_KEYS

    def one(path, t, spec):
        if stacked:
            spec = spec[1:]
        want = use_spec(path, spec, info)
        if want == spec:
            return t
        split = [i for i, a in enumerate(spec) if a]
        if stationary and vocab_dim(path) is not None:
            return StationaryTable(t, spec, info, vocab_dim(path))
        if (stationary and path.rsplit("/", 1)[-1] in _MATMUL
                and t.dim() == 2 and len(split) == 1
                and spec[split[0]] == (info.tp_axis,)):
            return SplitWeight(t, split[0], (info.tp_axis,), info)
        return gather_leaf(t, spec, info, keep=want)

    return _map(one, tree, specs, prefix)


# ---------------------------------------------------------------------------
# Init and caches
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose draws make shapes only (meta tensors)."""

    @property
    def device(self):
        return torch.device("meta")


@functools.lru_cache(maxsize=16)
def param_shapes(cfg, dtype=torch.float32) -> Dict:
    """The global parameter tree of ``cfg`` as meta tensors (shapes and
    dtypes, no data)."""
    from repro_torch.models import transformer
    return transformer.init_params(_MetaGenerator(), cfg, dtype)


class in_turn:
    """The ranks of ``info``'s mesh run the block one after another (a
    barrier between turns): the transients of each rank's block never
    coexist."""

    def __init__(self, info: MeshInfo):
        self.info = info

    def __enter__(self):
        for _ in range(self.info.rank):
            dist.barrier(group=self.info.group)
        return self

    def __exit__(self, *exc):
        for _ in range(self.info.world_size - self.info.rank):
            dist.barrier(group=self.info.group)
        return False


def init_local_params(model, info: MeshInfo, seed: int = 0,
                      mode: str = "train", dtype=torch.float32,
                      device=None) -> Dict:
    """This rank's blocks of ``model.init(seed, dtype, device)`` under
    ``make_param_specs(..., mode)``, drawn on ``device``. Every rank draws
    every leaf (the generator's sequence is the whole init's) and keeps
    its block; the ranks draw one after another, so one rank's whole
    leaves are alive at a time (nemotron-4-15b's embedding pair is 12.6
    GB)."""
    from repro_torch.kernels import backend
    from repro_torch.models import transformer
    cfg = model.cfg
    specs = make_param_specs(param_shapes(cfg, dtype), cfg, info, mode)

    def keep(path, t):
        node = specs
        for k in path.split("/"):
            node = node[k]
        spec = node[1:] if path.split("/", 1)[0] in SPLIT_KEYS else node
        block = local_slice(t, spec, info)
        return block if block is t else block.clone()

    dev = backend.resolve_device(device)
    with in_turn(info):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = transformer.init_params(gen, cfg, dtype, keep=keep)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    return params


def init_local_cache(model, info: MeshInfo, batch: int, buf_len: int,
                     dtype=torch.float32, device=None, cross_len: int = 0
                     ) -> Dict:
    """This rank's blocks of ``model.make_cache(batch, buf_len, ...)``
    under ``make_cache_specs`` (``batch`` the global batch): zeros, the
    slot positions -1, ``index`` 0."""
    from repro_torch.kernels import backend
    from repro_torch.models import transformer
    dev = backend.resolve_device(device)
    meta = transformer.init_cache(model.cfg, batch, buf_len, dtype,
                                  torch.device("meta"), cross_len=cross_len)
    specs = make_cache_specs(meta, model.cfg, info, batch)

    def one(path, t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        shape = local_shape(t.shape, spec, info)
        if path == "slot_pos":
            return torch.full(shape, -1, dtype=t.dtype, device=dev)
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    return _map(one, meta, specs)


def local_rows(x: torch.Tensor, info: MeshInfo, axes: Sequence[str]
               ) -> torch.Tensor:
    """This rank's rows (dim 0) of ``x`` split over ``axes``."""
    return local_slice(x, (tuple(axes),), info)
