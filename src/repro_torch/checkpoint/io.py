"""Tree checkpointing: flattened-leaf ``.npz`` + a JSON record of names,
dtypes and metadata (the counterpart of ``repro.checkpoint.io``, in its
file format: a checkpoint written by either package loads in the other,
bit for bit).

A file ``step_<8 digits>.npz`` holds ``leaf_<i>`` per leaf, in the JAX
package's leaf order (a dict's keys sorted at every level, lists and
tuples in order — ``ops.tree_flatten``'s order), and ``__meta__``:
``{"step", "names", "dtypes", "metadata"}`` with each leaf's path joined
by ``/``. bf16 leaves are stored as their uint16 bits and restored as
``torch.bfloat16``. Writes are atomic (a temporary file, then
``os.replace``); ``keep`` newest steps are retained. CUDA tensors are
copied to the host to be saved; loads return tensors on the device the
caller names.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint file is truncated or structurally corrupt.

    Raised instead of the raw ``zipfile``/``struct`` errors so callers can
    tell a PERMANENT failure (bad bytes on disk: retrying cannot help)
    from a transient one, and so the message names the offending path and
    row range instead of an opaque zip offset."""


def _flatten_with_names(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in ``ops.tree_flatten``'s order; a name is the
    leaf's dict keys and sequence indices joined by ``/``, as the JAX
    package's ``_key_str`` joins its ``tree_flatten_with_path`` path."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_names(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_names(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, the dtype name to record): bf16 as its uint16
    bits, since npz cannot hold it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dt: Optional[str], device) -> torch.Tensor:
    """Undo the uint16 storage view of bf16 leaves."""
    if dt == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``tree`` (tensors, numpy arrays or numbers at the leaves) as
    ``step_<step>.npz`` and keep the ``keep`` newest steps. Returns the
    file's path."""
    if keep < 1:
        # _retain(keep<=0) deletes everything — including the checkpoint
        # this very call just wrote; refuse rather than self-destruct
        raise ValueError(f"save_checkpoint requires keep >= 1, got {keep}")
    os.makedirs(ckpt_dir, exist_ok=True)
    named = _flatten_with_names(tree)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(named):
        a, dt = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = a
        dtypes.append(dt)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    meta = {"step": step, "names": [n for n, _ in named], "dtypes": dtypes,
            "metadata": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    _retain(ckpt_dir, keep)
    return path


def _retain(ckpt_dir: str, keep: int) -> None:
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    # keep <= 0 means retain nothing (ckpts[:-0] would be [] and keep all).
    # Deliberately stricter than save_checkpoint, which rejects keep < 1:
    # a purge is meaningful for a standalone cleanup call, but never as the
    # retention policy of the write that just happened.
    drop = ckpts if keep <= 0 else ckpts[:-keep]
    for old in drop:
        os.remove(os.path.join(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[5:13]) for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


def load_leaves(path: str, indices: Sequence[int], device="cpu"
                ) -> Tuple[List[torch.Tensor], Dict]:
    """Partial-row reads: fetch only the given leading-axis rows of every
    leaf in one checkpoint file, without materializing the full arrays.

    ``np.savez`` writes *stored* (uncompressed) zip members, so each
    ``leaf_i.npy`` member is seekable: its npy header is parsed, then each
    requested row's byte range is read. A K-row gather out of a D-row
    state file reads K rows, not D.

    Returns ``(leaves, meta)`` where ``leaves[i]`` has shape
    ``[len(indices), *trailing_i]`` on ``device`` with the checkpointed
    dtype restored (bf16 leaves come back as bf16, not their uint16
    storage view).
    """
    idx = np.asarray(indices, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"load_leaves: indices must be 1-D, got shape "
                         f"{idx.shape}")
    try:
        zf_ctx = zipfile.ZipFile(path)
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path!r} is corrupt or truncated: {e}") from e
    with zf_ctx as zf:
        try:
            with zf.open("__meta__.npy") as fh:
                meta = json.loads(str(np.lib.format.read_array(
                    fh, allow_pickle=False)))
        except (KeyError, zipfile.BadZipFile, ValueError) as e:
            raise CheckpointCorruptionError(
                f"checkpoint {path!r} is corrupt: cannot read its "
                f"__meta__ record ({e})") from e
        dtypes = meta.get("dtypes", [None] * len(meta["names"]))
        leaves: List[torch.Tensor] = []
        for i, dt in enumerate(dtypes):
            member = f"leaf_{i}.npy"
            info = zf.getinfo(member)
            if info.compress_type != zipfile.ZIP_STORED:
                # compressed members are not seekable in O(1): a full read
                # of this leaf only
                with zf.open(member) as fh:
                    full = np.lib.format.read_array(fh, allow_pickle=False)
                leaves.append(_to_tensor(full[idx], dt, device))
                continue
            with zf.open(member) as fh:
                version = np.lib.format.read_magic(fh)
                readers = {(1, 0): np.lib.format.read_array_header_1_0,
                           (2, 0): np.lib.format.read_array_header_2_0}
                if version not in readers:
                    raise ValueError(
                        f"load_leaves: leaf {i} in {path!r} uses npy format "
                        f"{version}; expected 1.0 or 2.0")
                shape, fortran, dtype = readers[version](fh)
                if fortran:
                    raise ValueError(
                        f"load_leaves: leaf {i} in {path!r} is "
                        "Fortran-ordered; partial-row reads need C order")
                if not shape:
                    raise ValueError(
                        f"load_leaves: leaf {i} in {path!r} is a scalar — "
                        "no leading row axis to index")
                data_start = fh.tell()
                row_shape = shape[1:]
                row_bytes = int(np.prod(row_shape, dtype=np.int64)
                                ) * dtype.itemsize
                bad = idx[(idx < 0) | (idx >= shape[0])]
                if bad.size:
                    raise IndexError(
                        f"load_leaves: indices {bad[:4].tolist()} out of "
                        f"range for leaf {i} with {shape[0]} rows")
                out = np.empty((idx.size,) + row_shape, dtype)
                flat = out.reshape(idx.size, -1)
                for j, r in enumerate(idx):
                    fh.seek(data_start + int(r) * row_bytes)
                    buf = fh.read(row_bytes)
                    if len(buf) != row_bytes:
                        raise CheckpointCorruptionError(
                            f"checkpoint {path!r} is truncated: leaf {i} "
                            f"row {int(r)} (requested rows "
                            f"{int(idx.min())}..{int(idx.max())} of "
                            f"{shape[0]}) yielded {len(buf)} of "
                            f"{row_bytes} bytes")
                    flat[j] = np.frombuffer(buf, dtype)
                leaves.append(_to_tensor(out, dt, device))
    return leaves, meta


def load_checkpoint(ckpt_dir: str, tree_like: Any,
                    step: Optional[int] = None, device="cpu"
                    ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (shapes must match), as
    tensors on ``device``; ``step=None`` takes the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = [_to_tensor(z[f"leaf_{i}"], dt, device) for i, dt in
                  enumerate(meta.get("dtypes", [None] * len(meta["names"])))]
    ref_leaves, treedef = ops.tree_flatten(tree_like)
    if len(ref_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint/model structure mismatch: {path} holds "
            f"{len(leaves)} leaves, tree_like expects {len(ref_leaves)}")
    return ops.tree_unflatten(treedef, leaves), meta
