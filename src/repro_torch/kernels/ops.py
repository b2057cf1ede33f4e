"""The flat-param packing seam and the mixing dispatchers (the counterpart
of ``repro.kernels.ops``).

A stacked tree of parameters (leaves [N, ...]) is flattened ONCE into a
single [N, sum(sizes)] buffer, the mixing kernels run over it, and the
result is unflattened. The packed columns follow JAX's leaf order — a
dict's keys sorted at every level, not its insertion order — so a packed
row lines up column for column with the JAX package's.

Dispatch goes by the tensor's device inside each kernel wrapper: CPU
tensors take the plain PyTorch version, CUDA tensors the hand-written
kernel (``fed_mix_segment``, ``fed_mix_matching``, ``fed_mix``,
``fed_mix_q``, ``fed_aggregate``; the LM stack's ``flash_attention`` and
``ssd_scan``). ``wire_flat`` is the quantized-exchange step both mixing
paths share.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch import compression
from repro_torch.kernels.fed_aggregate import fed_aggregate
from repro_torch.kernels.fed_mix import fed_mix
from repro_torch.kernels.fed_mix_q import fed_mix_q
from repro_torch.kernels.fed_mix_sparse import (  # noqa: F401 — dispatcher
    fed_mix_matching, fed_mix_segment,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401 — dispatcher
    flash_attention,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401 — dispatcher

_LOW_PRECISION = (torch.float16, torch.bfloat16)


# ---------------------------------------------------------------------------
# tree flattening in JAX's leaf order
# ---------------------------------------------------------------------------

def tree_flatten(tree):
    """(leaves, treedef): dicts in sorted-key order, lists/tuples in order,
    anything else a leaf — ``jax.tree_util.tree_flatten``'s order for these
    containers. ``treedef`` is a nested tuple, comparable with ``==``."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            sub, d = tree_flatten(v)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, len(tree), tuple(defs))
    return [tree], None


def tree_unflatten(treedef, leaves):
    # a module-level recursion, not a closure that calls itself: such a
    # closure is a reference cycle, and through its iterator it kept every
    # leaf alive until Python's cyclic collector ran (at full width, whole
    # param-sized trees past a train step)
    return _unflatten(treedef, iter(leaves))


def _unflatten(d, it):
    if d is None:
        return next(it)
    kind, keys, defs = d
    if kind == "dict":
        return {k: _unflatten(sub, it) for k, sub in zip(keys, defs)}
    vals = [_unflatten(sub, it) for sub in defs]
    return tuple(vals) if kind == "tuple" else vals


# ---------------------------------------------------------------------------
# flat-param packing
# ---------------------------------------------------------------------------

class TreeSpec(NamedTuple):
    """Recipe to undo ``pack_tree``: per-leaf trailing shapes/dtypes/sizes."""
    treedef: object
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]


def pack_tree(tree) -> Tuple[torch.Tensor, TreeSpec]:
    """Flatten a stacked tree (leaves [N, ...]) into one [N, sum(sizes)]
    buffer + the spec to unpack it. Leaf dtypes are kept per leaf in the
    spec; the buffer takes the promoted common dtype. Raises ValueError on
    an empty tree, scalar leaves, or leaves whose leading (client) axes
    disagree."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("pack_tree: empty tree (no tensor leaves) — "
                         "nothing to pack")
    for i, leaf in enumerate(leaves):
        if leaf.dim() < 1:
            raise ValueError(
                f"pack_tree: leaf {i} is a scalar (shape "
                f"{tuple(leaf.shape)}); every leaf needs a leading [N] "
                "client axis")
    n = leaves[0].shape[0]
    bad = {leaf.shape[0] for leaf in leaves if leaf.shape[0] != n}
    if bad:
        raise ValueError(
            f"pack_tree: leaves disagree on the leading client axis — got "
            f"N={n} and {sorted(bad)}; all leaves must share one [N, ...] "
            "stacking")
    spec = TreeSpec(treedef,
                    tuple(tuple(leaf.shape[1:]) for leaf in leaves),
                    tuple(leaf.dtype for leaf in leaves),
                    tuple(int(leaf[0].numel()) for leaf in leaves))
    dtype = functools.reduce(torch.promote_types, spec.dtypes)
    return torch.cat([leaf.reshape(n, -1).to(dtype) for leaf in leaves],
                     dim=1), spec


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 as XLA:CPU takes ``jnp.mean`` over a few rows: a
    running sum over the rows in order, times the reciprocal of N (XLA
    rewrites the divide), with f16/bf16 accumulated in f32 and cast back.
    That order makes the result bit-for-bit the reference's at the tests'
    sizes; it costs N - 1 row adds, which is negligible beside a round."""
    acc = torch.float32 if x.dtype in _LOW_PRECISION else x.dtype
    total = x[0].to(acc, copy=True)
    for row in x[1:]:
        total += row.to(acc)
    return (total * (1.0 / x.shape[0])).to(x.dtype)


def mean_packed(flat: torch.Tensor, spec: TreeSpec) -> torch.Tensor:
    """Mean over the leading (client) axis of a packed [N, sum(sizes)]
    buffer, RESPECTING per-leaf dtypes: each leaf's columns are reduced in
    that leaf's own dtype (what a per-leaf mean of ``unpack_tree`` gives)
    and the result is re-promoted to the buffer dtype. Uniform trees take
    the single whole-buffer reduction."""
    if all(dt == flat.dtype for dt in spec.dtypes):
        return _mean0(flat)
    outs, off = [], 0
    for dtype, sz in zip(spec.dtypes, spec.sizes):
        seg = flat[:, off:off + sz].to(dtype)
        outs.append(_mean0(seg).to(flat.dtype))
        off += sz
    return torch.cat(outs)


def unpack_tree(flat: torch.Tensor, spec: TreeSpec):
    """Undo ``pack_tree`` over the last axis: flat [..., sum(sizes)] ->
    tree with leaves [..., *leaf_shape] cast back to their original dtypes
    (views of ``flat`` where the dtype already matches)."""
    lead = tuple(flat.shape[:-1])
    outs, off = [], 0
    for shape, dtype, sz in zip(spec.shapes, spec.dtypes, spec.sizes):
        outs.append(flat[..., off:off + sz].reshape(lead + shape).to(dtype))
        off += sz
    return tree_unflatten(spec.treedef, outs)


def _check_state(name: str, flat) -> None:
    if getattr(flat, "ndim", 0) != 2:
        raise ValueError(
            f"{name}: expected a packed [D, sum(sizes)] buffer, got shape "
            f"{tuple(getattr(flat, 'shape', ()))}; pack the pytree with "
            "pack_tree first")


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``. To the card it goes through
    pinned memory with a non-blocking copy: a plain ``.to("cuda")`` of
    pageable memory waits for all of the stream's earlier work."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    if t.device != device and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _window_ids(name: str, ids, device: torch.device) -> torch.Tensor:
    """``ids`` as a 1-D int64 tensor on ``device``."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(ids)
    if ids.dim() != 1:
        raise ValueError(f"{name}: ids must be a 1-D [K] index vector, got "
                         f"shape {tuple(ids.shape)}")
    return host_to_device(ids.to(torch.int64), device)


def _check_window(name: str, flat, ids: torch.Tensor, rows) -> None:
    if getattr(rows, "ndim", 0) != 2:
        raise ValueError(
            f"{name}: expected packed 2-D buffers, got state shape "
            f"{tuple(flat.shape)} and window shape "
            f"{tuple(getattr(rows, 'shape', ()))}")
    if flat.shape[-1] != rows.shape[-1]:
        raise ValueError(
            f"{name}: window width {rows.shape[-1]} does not match the "
            f"state's packed width {flat.shape[-1]} — the two buffers were "
            "packed with different TreeSpecs")
    if ids.shape[0] != rows.shape[0]:
        raise ValueError(
            f"{name}: ids shape {tuple(ids.shape)} does not index the "
            f"[{rows.shape[0]}, ...] window (need one id per window row)")


def gather_rows(flat: torch.Tensor, ids) -> torch.Tensor:
    """Window a packed [D, sum(sizes)] buffer: rows ``ids`` -> a new [K,
    sum(sizes)] tensor, one ``index_select`` on the current stream (host
    ids reach the card without a host wait). The shared windowing seam of
    the sampled path (``protocols.store`` gathers active rows through
    it); ``gather_rows(flat, arange(D))`` is the identity window."""
    _check_state("gather_rows", flat)
    return flat.index_select(0, _window_ids("gather_rows", ids, flat.device))


#: the resident store's gather: the JAX package jits a device form of
#: ``gather_rows``; a PyTorch gather already runs where its state lives
gather_rows_dev = gather_rows


def scatter_rows(flat: torch.Tensor, ids, rows: torch.Tensor
                 ) -> torch.Tensor:
    """Write a [K, sum(sizes)] window into a copy of the packed [D,
    sum(sizes)] buffer at rows ``ids`` (the inverse seam of
    ``gather_rows``; ``flat`` is not modified). ``ids`` must be distinct
    — a sampled active set never repeats a client."""
    _check_state("scatter_rows", flat)
    ids = _window_ids("scatter_rows", ids, flat.device)
    _check_window("scatter_rows", flat, ids, rows)
    return flat.index_copy(0, ids, rows.to(flat.device, flat.dtype))


def scatter_rows_dev(flat: torch.Tensor, ids, rows: torch.Tensor
                     ) -> torch.Tensor:
    """``scatter_rows`` IN PLACE (``index_copy_``): the counterpart of the
    JAX package's donated scatter — the [K, sum(sizes)] window is written
    into the state buffer and nothing of size [D, sum(sizes)] is copied.
    Returns ``flat``."""
    _check_state("scatter_rows_dev", flat)
    ids = _window_ids("scatter_rows_dev", ids, flat.device)
    _check_window("scatter_rows_dev", flat, ids, rows)
    return flat.index_copy_(0, ids, rows.to(flat.device, flat.dtype))


def pack_tree_pair(f_new, f_old, caller: str = "fed_mix_tree"):
    """Pack two same-structure [D, ...] trees into flat buffers with ONE
    shared TreeSpec; mismatched structures raise instead of silently mixing
    misaligned columns. A tree that already is a ``packed_view`` gives its
    buffer itself."""
    flat_new, spec = packed_view(f_new) or pack_tree(f_new)
    flat_old, spec_old = packed_view(f_old) or pack_tree(f_old)
    if spec_old.treedef != spec.treedef or spec_old.shapes != spec.shapes:
        raise ValueError(
            f"{caller}: f_new/f_old tree structures differ "
            f"(new={spec.treedef} shapes={spec.shapes}, "
            f"old={spec_old.treedef} shapes={spec_old.shapes})")
    return flat_new, flat_old, spec


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def fed_aggregate_tree(stacked_params, w):
    """The paper's ``Aggregate(·)`` over a stacked tree (leaves [N, ...]):
    pack, one ``fed_aggregate`` pass over the [N, sum(sizes)] buffer,
    unpack to one model (leaves cast back to their own dtypes). A buffer
    of another dtype than f32 or bf16 is reduced in f32, as the JAX
    package reduces every leaf."""
    flat, spec = pack_tree(stacked_params)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.to(torch.float32)
    return unpack_tree(fed_aggregate(flat, w), spec)


# ---------------------------------------------------------------------------
# the quantized exchange and dense mixing on packed buffers
# ---------------------------------------------------------------------------

def wire_flat(codec, flat_new, flat_old, codec_state=None, *, u=None):
    """The flat-buffer quantized-exchange step, shared by the dense
    (``fed_mix_flat``) and structured (``protocols.spec.apply_spec_flat``)
    mixing paths: what crosses the wire is the round DELTA ``flat_new -
    flat_old`` against the round-start base, with the error-feedback
    residual of stateful codecs zero-initialized when None and folded in.
    ``u`` is the int8 codec's stochastic-rounding noise. Returns ``(enc,
    d_shape, base, new_state)`` — the wire record, the shape ``decode``
    needs, the f32 base, and the threaded codec state."""
    base = flat_old.to(torch.float32)
    d = flat_new.to(torch.float32) - base          # the uploaded delta
    if codec.stateful and codec_state is None:
        codec_state = torch.zeros_like(d)
    enc, d_shape, new_res = compression.feedback_encode(codec, d,
                                                        codec_state, u=u)
    return enc, d_shape, base, (new_res if codec.stateful else codec_state)


def fed_mix_flat(m_new, m_old, flat_new, flat_old, *, codec=None,
                 codec_state=None, u=None):
    """The dense mixing pass on already-packed [D, sum(sizes)] buffers —
    the seam the packed-state ``DenseEngine`` carry drives on
    ``mix_path="dense"``.

    ``codec`` (a ``repro_torch.compression`` name or Codec) puts the round
    DELTA through the lossy exchange; flat_old stays exact. The int8 codec
    never materializes the dequantized reconstruction: the ``fed_mix_q``
    kernel contracts the int8 record directly, folding the base back in as
    ``M_new @ dq(Q) + (M_new + M_old) @ X_old`` (= ``M_new @ (X_old + dq)
    + M_old @ X_old``). Other codecs decode, then ``fed_mix``. When
    ``codec`` is given the call returns ``(flat, new_codec_state)``."""
    codec_given = codec is not None
    codec = None if not codec_given else compression.active(codec)
    if codec is None:
        out = fed_mix(m_new, m_old, flat_new, flat_old)
        return (out, codec_state) if codec_given else out
    enc, d_shape, base, new_state = wire_flat(codec, flat_new, flat_old,
                                              codec_state, u=u)
    if isinstance(codec, compression.Int8Codec):
        out = fed_mix_q(m_new, m_new + m_old, enc.values, enc.scales,
                        flat_old, chunk=codec.chunk,
                        out_dtype=flat_new.dtype)
    else:
        x_hat = (base + codec.decode(enc, d_shape)).to(flat_new.dtype)
        out = fed_mix(m_new, m_old, x_hat, flat_old)
    return out, new_state


def fed_mix_tree(m_new, m_old, f_new, f_old, *, codec=None,
                 codec_state=None, u=None):
    """The dense mixing matrices over [D, ...] trees through ONE flat pass:
    pack both trees (none is copied that already is a ``packed_view``),
    ``fed_mix_flat``, unpack (views of the result). See ``fed_mix_flat``
    for the codec; with a codec the call returns ``(tree,
    new_codec_state)``."""
    flat_new, flat_old, spec = pack_tree_pair(f_new, f_old)
    if codec is None:
        return unpack_tree(fed_mix_flat(m_new, m_old, flat_new, flat_old),
                           spec)
    out, new_state = fed_mix_flat(m_new, m_old, flat_new, flat_old,
                                  codec=codec, codec_state=codec_state, u=u)
    return unpack_tree(out, spec), new_state


def packed_view(tree):
    """``(flat, spec)`` when ``tree`` is ``unpack_tree(flat, spec)`` of a
    contiguous [N, sum(sizes)] buffer: every leaf a view of ``flat``'s
    columns in leaf order, in ``flat``'s dtype. Else None. The engines keep
    the federated state so, and pack it again without a copy."""
    leaves, treedef = tree_flatten(tree)
    if not leaves or not all(isinstance(x, torch.Tensor) and x.dim() >= 1
                             for x in leaves):
        return None
    base = leaves[0]._base
    if (base is None or base.dim() != 2 or not base.is_contiguous()
            or base.shape[0] != leaves[0].shape[0]):
        return None
    n, width = base.shape
    item, off = base.element_size(), 0
    for leaf in leaves:
        size = leaf[0].numel() if n else 0
        if (leaf._base is not base or leaf.dtype != base.dtype
                or leaf.shape[0] != n
                or leaf.data_ptr() != base.data_ptr() + off * item
                or (n > 1 and leaf.stride(0) != width)
                or not leaf[0].is_contiguous()):
            return None
        off += size
    if off != width:
        return None
    spec = TreeSpec(treedef, tuple(tuple(x.shape[1:]) for x in leaves),
                    tuple(x.dtype for x in leaves),
                    tuple(int(x[0].numel()) for x in leaves))
    return base, spec
