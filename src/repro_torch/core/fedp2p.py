"""Federated rounds as a distributed program (the counterpart of
``repro.core.fedp2p``). Each client holds its own model replica and
local data; the round mechanics live in
``repro_torch.protocols.engine.MeshEngine``:

  1. local training — E SGD steps a client, no cross-client traffic;
  2. protocol mixing — through a ``RoundContext`` (the straggler mask,
     per-client |D_i| counts, the cluster assignment): on a mesh of ranks
     the protocol's ``psum_mix`` (all-reduces within each cluster's or
     pair's process group, and over every rank for the server step),
     on one card its ``mixing_spec`` kernels or the dense ``fed_mix``.

Federated state: every param leaf gains a leading client axis [D, ...],
kept as one packed [D, sum(sizes)] buffer whose leaves are views. On a
mesh each rank holds its own client's rows (``federated_rows``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import FLConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.protocols.engine import MeshEngine


def broadcast_to_clients(params, num_clients_dev: int):
    """Replicate one model into the federated [D, ...] state: one packed
    [D, sum(sizes)] buffer, its leaves views (what ``MeshEngine`` keeps)."""
    leaves, treedef = kernel_ops.tree_flatten(params)
    flat, spec = kernel_ops.pack_tree(kernel_ops.tree_unflatten(
        treedef, [leaf[None] for leaf in leaves]))
    return kernel_ops.unpack_tree(
        flat.expand(int(num_clients_dev), -1).contiguous(), spec)


def make_federated_round(model, fl: FLConfig, num_clients_dev: int,
                         local_steps: int, algorithm: str = "",
                         remat: bool = True, counts=None, mesh_info=None,
                         codec=None, mix_path=None,
                         device=None) -> Callable:
    """Returns round_fn(f_params, batches, draws, do_global_sync=True) ->
    (f_params, mean_loss): f_params leaves [D, ...] (on a mesh, this
    rank's rows), batches leaves [D, local_steps, ...] (e.g. tokens [D, T,
    B, S]), draws a ``MeshDraws`` (the survive mask and the round's other
    draws). ``algorithm`` is any registered protocol (default
    ``fl.algorithm``; unknown names raise), ``counts`` the per-client
    |D_i| weights (default uniform), ``codec`` the lossy wire (default
    ``fl.codec``), ``mix_path`` the one-card lowering (default
    ``fl.mix_path``), ``device`` None for the card."""
    engine = MeshEngine(model, fl, num_clients_dev, local_steps,
                        algorithm=algorithm, counts=counts, remat=remat,
                        mesh_info=mesh_info, codec=codec, mix_path=mix_path,
                        device=device)
    return engine.round_fn


def federated_rows(tree, mesh_info, axis: int = 0):
    """This rank's client rows of a [..., D, ...] tree, the client axis at
    ``axis``: the placement the JAX package states as shardings
    (``federated_state_specs`` for the state, ``axis=0``;
    ``federated_batch_specs`` for the batches, ``axis=1`` for run_rounds'
    [T, D, ...]). A packed state stays packed (one row block of its
    buffer). Without a mesh, the tree itself."""
    if mesh_info is None:
        return tree
    rows = list(mesh_info.clients)
    packed = kernel_ops.packed_view(tree) if axis == 0 else None
    if packed is not None:
        flat, spec = packed
        return kernel_ops.unpack_tree(flat[rows].contiguous(), spec)
    leaves, treedef = kernel_ops.tree_flatten(tree)
    idx = torch.tensor(rows, dtype=torch.int64)
    return kernel_ops.tree_unflatten(treedef, [
        leaf.index_select(axis, idx.to(leaf.device)) for leaf in leaves])
