"""The port's checkpoint I/O (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint``, in both directions: a checkpoint written by
either package loads in the other bit for bit (f32, bf16 restored as
bf16, int leaves), with the same leaf names, dtypes and metadata; the
partial-row ``load_leaves`` reads of either package's files agree;
retention (``keep``), ``latest_step``, and the errors: structure mismatch,
``keep < 1``, out-of-range and non-1-D indices, truncated files
(``CheckpointCorruptionError`` naming the path and the row range), no
checkpoint at all.
"""
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import io as jio  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 3)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((6, 2, 2)).astype(np.float32),
                        "steps": np.arange(6, dtype=np.int32)},
                       {"k": rng.standard_normal((6, 4)).astype(np.float32),
                        "steps": np.arange(6, 12, dtype=np.int32)}]}


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_torch_tree(v) for v in t]
    return torch.from_numpy(t)


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _with_bf16(tree, make_bf16):
    out = dict(tree)
    out["b"] = make_bf16(tree["b"])
    return out


def _leaves_bits(tree):
    """Each leaf's raw bits (bf16 as uint16), in JAX's leaf order."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                out.append(("bfloat16", leaf.view(torch.int16).numpy()
                            .view(np.uint16).tobytes()))
            else:
                out.append((str(leaf.numpy().dtype), leaf.numpy().tobytes()))
        else:
            a = np.asarray(leaf)
            if str(a.dtype) == "bfloat16":
                out.append(("bfloat16", a.view(np.uint16).tobytes()))
            else:
                out.append((str(a.dtype), a.tobytes()))
    return out


def test_port_writes_jax_reads_bit_for_bit(tmp_path):
    np_tree = _numpy_tree()
    tree = _with_bf16(_torch_tree(np_tree), lambda t: t.to(torch.bfloat16))
    path = io.save_checkpoint(str(tmp_path), 3, tree, metadata={"lr": 0.1})
    assert os.path.basename(path) == "step_00000003.npz"
    jlike = _with_bf16(_jax_tree(np_tree), lambda t: t.astype(jnp.bfloat16))
    out, meta = jio.load_checkpoint(str(tmp_path), jlike)
    assert meta["step"] == 3 and meta["metadata"] == {"lr": 0.1}
    assert _leaves_bits(out) == _leaves_bits(tree)
    # the names and dtypes JAX itself records for the same tree
    jdir = tmp_path / "jax"
    jio.save_checkpoint(str(jdir), 3, jlike)
    _, jmeta = jio.load_checkpoint(str(jdir), jlike)
    assert meta["names"] == jmeta["names"]
    assert meta["dtypes"] == jmeta["dtypes"]
    assert "bfloat16" in meta["dtypes"] and "int32" in meta["dtypes"]


def test_jax_writes_port_reads_bit_for_bit(tmp_path):
    np_tree = _numpy_tree(1)
    jtree = _with_bf16(_jax_tree(np_tree), lambda t: t.astype(jnp.bfloat16))
    jio.save_checkpoint(str(tmp_path), 12, jtree, metadata={"round": 4})
    like = _with_bf16(_torch_tree(np_tree), lambda t: t.to(torch.bfloat16))
    out, meta = io.load_checkpoint(str(tmp_path), like)
    assert meta["metadata"] == {"round": 4}
    assert out["b"].dtype == torch.bfloat16
    assert out["layers"][0]["steps"].dtype == torch.int32
    assert _leaves_bits(out) == _leaves_bits(jtree)
    assert all(leaf.device.type == "cpu"
               for leaf in jax.tree_util.tree_leaves(
                   out, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_leaves_cross_read(tmp_path, writer):
    np_tree = _numpy_tree(2)
    if writer == "port":
        tree = _with_bf16(_torch_tree(np_tree),
                          lambda t: t.to(torch.bfloat16))
        path = io.save_checkpoint(str(tmp_path), 1, tree)
    else:
        tree = _with_bf16(_jax_tree(np_tree),
                          lambda t: t.astype(jnp.bfloat16))
        path = jio.save_checkpoint(str(tmp_path), 1, tree)
    rows = [5, 0, 3, 3]
    got, meta = io.load_leaves(path, rows)
    want, jmeta = jio.load_leaves(path, rows)
    assert meta == jmeta and len(got) == len(want)
    for g, w, dt in zip(got, want, meta["dtypes"]):
        assert tuple(g.shape) == w.shape
        if dt == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert (g.view(torch.int16).numpy().view(np.uint16).tobytes()
                    == np.asarray(w).view(np.uint16).tobytes())
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # the rows agree with a full load (leaf 0 is "b", the last "w")
    full, _ = io.load_checkpoint(str(tmp_path), _torch_tree(np_tree))
    assert torch.equal(got[0], full["b"][rows])
    assert torch.equal(got[-1], full["w"][rows])


def test_retention_and_latest_step(tmp_path):
    tree = _torch_tree(_numpy_tree())
    d = str(tmp_path)
    assert io.latest_step(d) is None
    assert io.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        io.load_checkpoint(d, tree)
    for step in (1, 2, 3, 4):
        io.save_checkpoint(d, step, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003.npz", "step_00000004.npz"]
    assert io.latest_step(d) == jio.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        io.load_checkpoint(d, tree, step=1)
    io._retain(d, 0)
    assert os.listdir(d) == []
    with pytest.raises(ValueError, match="keep >= 1"):
        io.save_checkpoint(d, 5, tree, keep=0)
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_errors(tmp_path):
    tree = _torch_tree(_numpy_tree())
    path = io.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        io.load_checkpoint(str(tmp_path), {"only": torch.zeros(2)})
    with pytest.raises(IndexError, match="out of range"):
        io.load_leaves(path, [6])
    with pytest.raises(ValueError, match="1-D"):
        io.load_leaves(path, [[0, 1]])
    data = Path(path).read_bytes()
    cut = tmp_path / "cut" / "step_00000001.npz"
    cut.parent.mkdir()
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(io.CheckpointCorruptionError, match=str(cut)):
        io.load_leaves(str(cut), [0])
    # a whole zip with one leaf cut short: the row range is named
    short = tmp_path / "short.npz"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(short, "w") as zout:
        for info in zin.infolist():
            blob = zin.read(info.filename)
            if info.filename == "leaf_4.npy":   # layers/1/steps, [6] int32
                blob = blob[:-20]
            zout.writestr(info, blob)
    with pytest.raises(io.CheckpointCorruptionError, match=r"rows 1\.\.5"):
        io.load_leaves(str(short), [1, 5])


def test_cuda_tensors_are_saved_from_the_host(tmp_path, monkeypatch):
    """A leaf on another device is copied to the host to be saved: the
    tensor's ``.cpu()`` is taken before numpy sees it."""
    calls = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        calls.append(self.dtype)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    tree = _with_bf16(_torch_tree(_numpy_tree()),
                      lambda t: t.to(torch.bfloat16))
    io.save_checkpoint(str(tmp_path), 1, tree)
    assert len(calls) == 6 and torch.bfloat16 in calls
