"""The mesh record and the sharding rules (the counterpart of
``repro.sharding.rules``).

Three strategies, chosen per architecture against the mesh's ``model``
axis, exactly as the JAX package chooses them:

  tp     — attention heads, the MLP's hidden units, the experts and the
           vocabulary over ``model``, plus FSDP over the data axes.
           Requires num_heads % model == 0 (and num_experts % model == 0).
  seqtp  — heads not divisible by ``model``: weights ZeRO-3 over
           (data, model) jointly; activations batch-sharded over the data
           axes; the ``model`` axis contributes memory capacity.
  dp     — SSM-bearing archs (mamba2, hymba): laid out like seqtp.

A spec is a tuple with one entry a dimension, each entry the tuple of mesh
axes that dimension is split over (``()``: whole), in the order the JAX
package's ``PartitionSpec`` names them: its ``P('model', ('data',))`` is
``(('model',), ('data',))`` here. The spec functions read only the mesh's
axis names and sizes, so they run on a mesh with no process group (an
abstract one), as the JAX package's run on an ``AbstractMesh``.

GSPMD has no counterpart in PyTorch: each rank holds the slices its specs
give it (``sharding/place.py``), the modules run on their local slices and
call, on the process group of the mesh axis concerned, the collective GSPMD
would insert (``MeshInfo.all_gather`` / ``all_reduce`` / ``all_to_all``).
The process groups are made by ``launch.mesh.make_mesh``: one for each
line of each set of axes, on every rank in the same order. Rank r's
coordinates are r's row-major index over the mesh's shape (``model``
fastest).

The client axes of a federated mesh (``(data=D, model=1)``, one
client a rank, ``MeshEngine``'s ``psum_mix``) read ``MeshInfo.psum`` and
``build_groups``: a grouped psum (JAX's ``axis_index_groups``) is an
``all_reduce`` over one ``new_group`` per group. ``torch.distributed``
requires every rank to create every group, members or not, in the same
order, so a partition's groups are made together (``build_groups``) the
first time it is used; engines make theirs when they are constructed.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Tuple[str, ...], ...]
# one all-gather into a flat output (its newer name where torch has it)
_ALL_GATHER_FLAT = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
SPLIT_KEYS = ("layers", "dense_layers")      # subtrees stacked [L, ...]


def P(*entries) -> Spec:
    """A spec from ``PartitionSpec``-style entries: None (whole), an axis
    name, or a tuple of axis names."""
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in entries)


@dataclass
class CommStats:
    """Wall seconds and calls of this rank's model-axis collectives (host
    clock around each call; gloo with CUDA tensors returns once the data
    has gone through the host)."""
    seconds: float = 0.0
    calls: int = 0

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


@dataclass(frozen=True)
class MeshInfo:
    """This rank on a mesh of ``torch.distributed`` ranks.

    ``group`` is the process group of the whole mesh (None: the default
    group), ``rank`` / ``world_size`` this rank's place in it;
    ``dp_axes`` the data axes, ``('data',)`` or ``('pod', 'data')``;
    ``clients`` the client rows this rank holds on a federated mesh (its
    index along the data axes); ``axis_names`` / ``axis_sizes`` the mesh;
    ``tp_axis`` the model axis and ``strategy`` the model's layout on it
    (``choose_strategy``); ``coords`` this rank's coordinate on each axis,
    empty for an abstract mesh (specs only: a collective raises);
    ``lines`` this rank's process group for each set of axes (None where
    the line holds only this rank)."""
    group: Optional[object]
    rank: int
    world_size: int
    dp_axes: Tuple[str, ...]
    clients: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = ()
    tp_axis: str = "model"
    strategy: str = "dp"
    coords: Tuple[int, ...] = ()
    lines: Dict[Tuple[str, ...], object] = field(
        default_factory=dict, compare=False, repr=False)
    comm: CommStats = field(default_factory=CommStats, compare=False,
                            repr=False)
    _groups: Dict[Tuple[int, ...], object] = field(
        default_factory=dict, compare=False, repr=False)

    # ---- the mesh's shape ------------------------------------------------

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, axes: Sequence[str]) -> int:
        s = self.sizes
        return math.prod(s[a] for a in axes)

    @property
    def dp_size(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.sizes[self.tp_axis]

    @property
    def abstract(self) -> bool:
        return not self.coords

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (in the mesh's order:
        the combined index of a ``('data', 'model')`` split)."""
        if self.abstract:
            raise RuntimeError("an abstract mesh has no ranks")
        c, s = dict(zip(self.axis_names, self.coords)), self.sizes
        i = 0
        for a in axes:
            i = i * s[a] + c[a]
        return i

    @property
    def tp_index(self) -> int:
        return self.index((self.tp_axis,))

    # ---- model-axis collectives over the line of ``axes`` ------------------

    def _line(self, axes: Sequence[str]):
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.abstract:
            raise RuntimeError("an abstract mesh has no process groups")
        return axes, self.lines.get(axes)

    def _timed(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.comm.seconds += time.perf_counter() - t0
        self.comm.calls += 1
        return out

    def all_gather(self, x: torch.Tensor, dim: int, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Concatenate the line's slices of ``x`` along ``dim`` in the
        order of their index over ``axes`` (the inverse of the slicing
        of a dimension split over ``axes``)."""
        axes, g = self._line(axes)
        n = self.size(axes)
        if n == 1:
            return x
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._timed(_ALL_GATHER_FLAT, out, x.contiguous(), group=g)
        if dim == 0:
            return out
        return out.reshape((n,) + tuple(x.shape)).movedim(0, dim).reshape(
            x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Sum ``x`` IN PLACE over the line of ``axes`` and return it."""
        axes, g = self._line(axes)
        if self.size(axes) > 1:
            self._timed(dist.all_reduce, x, op=dist.ReduceOp.SUM, group=g)
        return x

    def all_to_all(self, x: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Block i of ``x`` along dim 0 (n equal blocks, n the line's size)
        goes to the line's rank i; block j of the result came from rank
        j."""
        axes, g = self._line(axes)
        if self.size(axes) == 1:
            return x
        out = torch.empty_like(x)
        self._timed(dist.all_to_all_single, out, x.contiguous(), group=g)
        return out

    # ---- the client axes (federated meshes, one client a rank) -------------

    def _global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def build_groups(self, partitions: Sequence[Sequence[Sequence[int]]]
                     ) -> None:
        """Make the process group of every group of ``partitions`` (each
        a partition of the ranks into groups) not made yet, in order.
        Singletons need none (a psum over one rank is the identity) and a
        group of every rank is ``group`` itself. Every rank must make the
        same calls in the same order."""
        for part in partitions:
            for g in part:
                key = tuple(int(r) for r in g)
                if (len(key) in (1, self.world_size)
                        or key in self._groups):
                    continue
                self._groups[key] = dist.new_group(
                    [self._global_rank(r) for r in key])

    def psum(self, x: torch.Tensor, groups=None) -> torch.Tensor:
        """Sum ``x`` IN PLACE over the ranks of this rank's group of the
        partition ``groups`` (None: over every rank) and return it: one
        ``all_reduce(SUM)``; nothing for a singleton group."""
        if groups is not None:
            mine = next(tuple(int(r) for r in g) for g in groups
                        if self.rank in g)
            if len(mine) == 1:
                return x
            if len(mine) < self.world_size:
                if mine not in self._groups:
                    self.build_groups([groups])
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self._groups[mine])
                return x
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def choose_strategy(cfg, tp_size: int) -> str:
    """The model's layout on a model axis of ``tp_size`` (None: a mesh
    that carries no model, the federated client axes: ``dp``)."""
    if cfg is None or cfg.family == "ssm" or cfg.ssm_state:
        return "dp"
    if cfg.num_heads % tp_size == 0 and (
            cfg.num_experts == 0 or cfg.num_experts % tp_size == 0):
        return "tp"
    return "seqtp"


def abstract_mesh_info(cfg, shape: Sequence[int],
                       axis_names: Sequence[str]) -> MeshInfo:
    """The ``MeshInfo`` of a mesh of axis sizes and names only, with no
    process group: it gives specs, and its collectives raise (the JAX
    package's ``AbstractMesh``)."""
    names, shape = tuple(axis_names), tuple(shape)
    sizes = dict(zip(names, shape))
    return MeshInfo(group=None, rank=0, world_size=math.prod(shape),
                    dp_axes=tuple(a for a in ("pod", "data") if a in sizes),
                    clients=(), axis_names=names, axis_sizes=shape,
                    strategy=choose_strategy(cfg, sizes.get("model", 1)))


def make_mesh_info(cfg, mesh) -> MeshInfo:
    """The ``MeshInfo`` of this rank on ``mesh`` (``launch.mesh.Mesh``)
    for the model ``cfg`` (None on a federated mesh of clients). Without
    an initialized process group the info is abstract: it gives specs, and
    its collectives raise. Raises when the process group's size is not the
    mesh's."""
    names, shape = tuple(mesh.axis_names), tuple(mesh.shape)
    if not dist.is_initialized():
        return abstract_mesh_info(cfg, shape, names)
    sizes = dict(zip(names, shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    strategy = choose_strategy(cfg, sizes.get("model", 1))
    n = math.prod(shape)
    rank = dist.get_rank(mesh.group)
    world = dist.get_world_size(mesh.group)
    if n != world:
        raise ValueError(f"mesh {sizes} holds {n} ranks, but the process "
                         f"group has {world}")
    coords, r = [], rank
    for s in reversed(shape):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    client = 0
    for a in dp_axes:
        client = client * sizes[a] + coords[names.index(a)]
    return MeshInfo(group=mesh.group, rank=rank, world_size=world,
                    dp_axes=dp_axes, clients=(client,), axis_names=names,
                    axis_sizes=shape, strategy=strategy, coords=coords,
                    lines=dict(getattr(mesh, "lines", None) or {}))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _div(n: int, axes: Tuple[str, ...], info: MeshInfo) -> bool:
    return n % info.size(axes) == 0


def _embed_spec(shape, info: MeshInfo) -> Spec:
    """[V, d] table: prefer vocab over model (logits stay vocab-sharded,
    lookups mask+reduce); guard every sharded dim for divisibility."""
    dp, tp = info.dp_axes, info.tp_axis
    v, d = shape
    if _div(v, (tp,), info):
        return P(tp, dp if _div(d, dp, info) else None)
    if _div(d, dp + (tp,), info):
        return P(None, dp + (tp,))
    if _div(d, (tp,), info):
        return P(None, tp)
    return P(None, dp if _div(d, dp, info) else None)


def _unembed_spec(shape, info: MeshInfo) -> Spec:
    """[d, V] projection: vocab over model when divisible."""
    dp, tp = info.dp_axes, info.tp_axis
    d, v = shape
    if _div(v, (tp,), info):
        return P(dp if _div(d, dp, info) else None, tp)
    if _div(d, dp + (tp,), info):
        return P(dp + (tp,), None)
    return P(dp if _div(d, dp, info) else None, None)


def _is_vocab(path: str) -> bool:
    return (path.endswith("embed/unembed") or path.endswith("/heads")
            or path == "heads")


def _tp_leaf_spec(path: str, shape, info: MeshInfo) -> Spec:
    """Per-tensor rules for the ``tp`` strategy. ``path`` has the stacked
    L dim stripped from ``shape``; the caller re-pads the spec."""
    dp, tp = info.dp_axes, info.tp_axis
    whole = P(*([None] * len(shape)))

    def fs(i: int):
        return dp if _div(shape[i], dp, info) else None

    if path.endswith("embed/table"):
        return _embed_spec(shape, info)
    if _is_vocab(path):
        return _unembed_spec(shape, info)
    name = path.rsplit("/", 1)[-1]
    if "/attn/" in path or "/cross/" in path:
        if name == "wq":
            return P(fs(0), tp)
        if name in ("wk", "wv"):
            return P(fs(0), tp if shape[1] % info.tp_size == 0 else None)
        if name == "wo":
            return P(tp, fs(1))
        if name == "bq":
            return P(tp if shape[0] % info.tp_size == 0 else None)
        if name in ("w_dq", "w_dkv", "w_kr"):           # MLA
            return P(fs(0), None)
        if name in ("w_uq", "w_uk", "w_uv"):
            return P(None, tp, None)
        return whole
    if "/mlp/" in path or "/shared/" in path:
        if name in ("w_in", "w_gate"):
            return P(fs(0), tp)
        if name == "w_out":
            return P(tp, fs(1))
        if name == "b_in":
            return P(tp)
        return whole
    if "/moe/" in path:
        if name in ("w_in", "w_gate"):
            return P(tp, fs(1), None)
        if name == "w_out":
            return P(tp, None, fs(2))
        if name == "router":
            return P(fs(0), None)
        return whole
    if "/ssm/" in path and name in ("in_proj", "out_proj"):
        return P(fs(0), None)
    return whole


def _zero3_leaf_spec(path: str, shape, info: MeshInfo) -> Spec:
    """seqtp/dp: shard the largest suitable dim over (dp..., model)
    jointly, falling back to dp only, then model only, then replicate.
    Embeddings keep the tp layout (vocab over model)."""
    dp, tp = info.dp_axes, info.tp_axis
    if path.endswith("embed/table"):
        return _embed_spec(shape, info)
    if _is_vocab(path):
        return _unembed_spec(shape, info)
    if len(shape) < 2 or min(shape) == 0:
        return P(*([None] * len(shape)))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        for axes in (dp + (tp,), dp, (tp,)):
            if _div(shape[i], axes, info):
                spec = [None] * len(shape)
                spec[i] = axes
                return P(*spec)
    return P(*([None] * len(shape)))


def _decode_respec(path: str, shape, spec: Spec, info: MeshInfo) -> Spec:
    """Weight-stationary decode: drop the data axes from the weights'
    specs (no per-token weight gathers); where the model axis then splits
    nothing, put it on the last dim it divides. Experts and embeddings
    keep their train layout."""
    if "/moe/w_" in path or "embed/" in path or _is_vocab(path):
        return spec
    kept = tuple(tuple(a for a in e if a not in info.dp_axes) for e in spec)
    if kept == spec:
        return spec
    if all(not e for e in kept):
        for dim in range(len(shape) - 1, -1, -1):
            if shape[dim] % info.tp_size == 0:
                es = [None] * len(shape)
                es[dim] = info.tp_axis
                return P(*es)
    return kept


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, depth first in insertion order, the
    path its keys joined by '/' (the JAX package's key paths)."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from tree_paths(v, path)
        else:
            yield path, v


def _map_paths(fn, tree, prefix: str = ""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map_paths(fn, v, path) if isinstance(v, dict) else fn(
            path, v)
    return out


def leaf_spec(path: str, shape, cfg, info: MeshInfo, mode: str = "train"
              ) -> Spec:
    """The spec of one parameter leaf of global ``shape`` at ``path``
    (the leaves under ``layers`` / ``dense_layers`` carry a leading L dim,
    left whole)."""
    leaf_fn = _tp_leaf_spec if info.strategy == "tp" else _zero3_leaf_spec
    stacked = path.split("/", 1)[0] in SPLIT_KEYS
    inner = tuple(shape[1:]) if stacked else tuple(shape)
    spec = leaf_fn(path, inner, info)
    if mode == "decode":
        spec = _decode_respec(path, inner, spec, info)
    spec = spec + P(*([None] * (len(inner) - len(spec))))
    return P(None) + spec if stacked else spec


def make_param_specs(params, cfg, info: MeshInfo, mode: str = "train"):
    """The spec tree of ``params`` (a tree of tensors, or of shapes: any
    leaf with ``.shape``). ``mode='decode'`` is the weight-stationary
    layout."""
    return _map_paths(lambda path, leaf: leaf_spec(path, tuple(leaf.shape),
                                                   cfg, info, mode), params)


# ---------------------------------------------------------------------------
# Activation rules
# ---------------------------------------------------------------------------

def batch_dims(info: MeshInfo, batch: int, mode: str = "train",
               vocab_size: int = 0) -> Tuple[str, ...]:
    """Mesh axes of the batch dim. For seqtp/dp TRAINING the model axis
    joins data parallelism when the global batch divides (vocabularies up
    to 64k only); else the data axes, else the last of them, else none."""
    dp = info.dp_axes
    if (info.strategy != "tp" and mode == "train"
            and 0 < vocab_size <= 65_536
            and batch % (info.dp_size * info.tp_size) == 0):
        return dp + (info.tp_axis,)
    if batch % info.dp_size == 0:
        return dp
    if batch % info.sizes[dp[-1]] == 0:
        return dp[-1:]
    return ()


def make_activation_rules(cfg, info: MeshInfo, *, mode: str,
                          batch: int) -> Dict[str, Spec]:
    """Logical activation names -> spec. ``mode``: train | prefill |
    decode."""
    tp = info.tp_axis
    bdp = batch_dims(info, batch, mode, cfg.vocab_size)
    b = bdp if bdp else None
    rules: Dict[str, Spec] = {}
    if info.strategy == "tp":
        kv_tp = tp if ((cfg.num_kv_heads * cfg.head_dim) % info.tp_size == 0
                       and cfg.num_kv_heads % info.tp_size == 0) else None
        rules["act_btd"] = P(b, None, None)
        rules["act_q"] = P(b, None, tp)
        rules["act_kv"] = P(b, None, kv_tp)
        rules["act_btv"] = P(b, None, tp)
        rules["moe_ecd"] = P(tp, None, None)
    else:
        vocab_tp = None if (bdp and tp in bdp) else tp
        rules["act_btd"] = P(b, None, None)
        rules["act_q"] = P(b, None, None)
        rules["act_kv"] = P(b, None, None)
        rules["act_btv"] = P(b, None, vocab_tp)
        rules["moe_ecd"] = P(tp, None, None)
    return rules


def cache_batch_axes(info: MeshInfo, batch: int) -> Tuple[str, ...]:
    dp = info.dp_axes
    if batch % info.dp_size == 0:
        return dp
    if batch % info.sizes[dp[-1]] == 0:
        return dp[-1:]
    return ()


def make_cache_specs(cache, cfg, info: MeshInfo, batch: int):
    """KV-cache specs: the buffer (slot) dim over ``model`` where it
    divides, the batch over the data axes. ``index`` (a Python int in the
    port) and ``slot_pos`` stay whole."""
    b = cache_batch_axes(info, batch) or None
    tp = info.tp_axis

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        shape = tuple(getattr(leaf, "shape", ()))
        if name in ("k", "v", "latent", "k_rope"):         # [L, B, buf, ...]
            buf_tp = tp if shape[2] % info.tp_size == 0 else None
            return P(None, b, buf_tp, *([None] * (len(shape) - 3)))
        if name in ("conv", "state", "cross_k", "cross_v"):   # [L, B, ...]
            return P(None, b, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return _map_paths(one, cache)
