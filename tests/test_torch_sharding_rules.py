"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's, entry for entry, on meshes of axis sizes and names only (a
``jax.sharding.AbstractMesh`` on the JAX side, ``abstract_mesh_info`` on
the port's); no process is started.

For every arch of ``ARCH_IDS`` at its published widths, on the production
meshes (16, 16) and (2, 16, 16) and the small ones (2, 4), (1, 4), (2, 2)
and (4, 1), in the train and decode layouts: every parameter leaf's spec
(the JAX params from ``jax.eval_shape(model.init, key)``, the port's from
``sharding.place.param_shapes``) and its local shape (JAX's
``NamedSharding.shard_shape``); ``choose_strategy``, ``batch_dims`` and
``make_activation_rules`` (train, prefill and decode at several global
batches); ``make_cache_specs`` of every cache leaf the two packages share;
the shape registry; ``data/pipeline.py``'s rows and specs against JAX's
``batch_shardings``.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.config import ShapeConfig as JShape
from repro.configs import ARCH_IDS, get_config as jax_config
from repro.data.pipeline import batch_shardings as jbatch_shardings
from repro.models.model import build_model as jax_build
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, get_config, get_shape
from repro_torch.data.pipeline import batch_shardings, sharded_batches
from repro_torch.models import transformer
from repro_torch.sharding import rules
from repro_torch.sharding.place import local_shape, param_shapes

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model"))]
MESH_IDS = ["x".join(map(str, m[0])) for m in MESHES]
BATCHES = (1, 2, 4, 6, 8, 32, 128, 256)

_jax_shapes = {}


def _jax_params(arch):
    if arch not in _jax_shapes:
        _jax_shapes[arch] = jax.eval_shape(jax_build(jax_config(arch)).init,
                                           jax.random.PRNGKey(0))
    return _jax_shapes[arch]


def norm(spec, ndim):
    """A ``PartitionSpec`` as the port writes specs: each entry the tuple
    of its axis names, padded to ``ndim``."""
    out = tuple(() if e is None else ((e,) if isinstance(e, str)
                                      else tuple(e)) for e in spec)
    return out + ((),) * (ndim - len(out))


def _infos(arch, mesh):
    shape, names = mesh
    jinfo = jrules.make_mesh_info(jax_config(arch),
                                  AbstractMesh(shape, names))
    return jinfo, rules.abstract_mesh_info(get_config(arch), shape, names)


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in
                     path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree):
    return dict(rules.tree_paths(tree))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh):
    jinfo, info = _infos(arch, mesh)
    assert info.strategy == jinfo.strategy
    jparams = _jax_params(arch)
    shapes = param_shapes(get_config(arch))
    for mode in ("train", "decode"):
        want = _jax_leaves(jrules.make_param_specs(jparams, jax_config(arch),
                                                   jinfo, mode))
        got = _port_leaves(rules.make_param_specs(shapes, get_config(arch),
                                                  info, mode))
        leaves = _jax_leaves(jparams)
        assert set(got) == set(want), (mode, set(got) ^ set(want))
        for path, sharding in want.items():
            shape = tuple(leaves[path].shape)
            assert got[path] == norm(sharding.spec, len(shape)), (
                mode, path, got[path], sharding.spec)
            jshard = NamedSharding(jinfo.mesh, sharding.spec)
            assert local_shape(shape, got[path], info) == tuple(
                jshard.shard_shape(shape)), (mode, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_strategy_equal_jax(arch):
    for tp in (1, 2, 3, 4, 8, 16):
        assert rules.choose_strategy(get_config(arch), tp) == \
            jrules.choose_strategy(jax_config(arch), tp), tp


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_rules_equal_jax(arch, mesh):
    jinfo, info = _infos(arch, mesh)
    cfg, jcfg = get_config(arch), jax_config(arch)
    for mode in ("train", "prefill", "decode"):
        for batch in BATCHES:
            assert rules.batch_dims(info, batch, mode, cfg.vocab_size) == \
                jrules.batch_dims(jinfo, batch, mode, jcfg.vocab_size), (
                    mode, batch)
            got = rules.make_activation_rules(cfg, info, mode=mode,
                                              batch=batch)
            want = jrules.make_activation_rules(jcfg, jinfo, mode=mode,
                                                batch=batch)
            assert set(got) == set(want)
            for name, sh in want.items():
                assert got[name] == norm(sh.spec, len(got[name])), (
                    mode, batch, name)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch, mesh):
    jinfo, info = _infos(arch, mesh)
    cfg, jcfg = get_config(arch), jax_config(arch)
    cross = 8 if cfg.cross_attend else 0
    for batch, buf in ((1, 8), (4, 2056), (6, 1152), (32, 4096)):
        jcache = jax.eval_shape(lambda: jax_build(jcfg).make_cache(
            batch, buf, cross_len=cross))
        want = _jax_leaves(jrules.make_cache_specs(jcache, jcfg, jinfo,
                                                   batch))
        leaves = _jax_leaves(jcache)
        cache = transformer.init_cache(cfg, batch, buf,
                                       device=torch.device("meta"),
                                       cross_len=cross)
        got = _port_leaves(rules.make_cache_specs(cache, cfg, info, batch))
        assert set(got) == set(want)
        for path, sh in want.items():
            nd = len(leaves[path].shape)
            assert got[path] == norm(sh.spec, nd), (batch, buf, path)


def test_shapes_registry_equal_jax():
    from repro.configs import SHAPES as JSHAPES, get_shape as jget
    assert set(SHAPES) == set(JSHAPES)
    for name in SHAPES:
        a, b = get_shape(name), jget(name)
        assert (a.name, a.seq_len, a.global_batch, a.mode) == (
            b.name, b.seq_len, b.global_batch, b.mode)
    with pytest.raises(KeyError):
        get_shape("nope")


def test_abstract_mesh_has_no_collectives():
    info = rules.abstract_mesh_info(get_config("qwen2-1.5b"), (2, 2),
                                    ("data", "model"))
    assert (info.dp_size, info.tp_size, info.strategy) == (2, 2, "tp")
    with pytest.raises(RuntimeError, match="abstract"):
        info.all_reduce(np.zeros(1), ("model",))


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("mesh", MESHES[2:], ids=MESH_IDS[2:])
def test_pipeline_rows_equal_jax_batch_shardings(shape_name, mesh):
    """``data/pipeline.py``: each rank's spec of a host batch leaf is the
    JAX package's ``batch_shardings``', its rows are its block of the
    batch dim (the ranks' blocks cover the batch), and
    ``sharded_batches`` hands each rank its rows of every batch in
    order."""
    arch = "qwen2-1.5b"
    base = get_shape(shape_name)
    for batch in (base.global_batch, 4, 6):
        shape = dataclasses.replace(base, global_batch=batch)
        jinfo, info = _infos(arch, mesh)
        leaf = np.zeros((batch, 8), np.int32)
        jspec = jbatch_shardings(jax_config(arch), JShape(
            **dataclasses.asdict(shape)), jinfo)(leaf).spec
        local = NamedSharding(jinfo.mesh, jspec).shard_shape(leaf.shape)[0]
        host = [{"tokens": np.arange(batch * 3).reshape(batch, 3) + 100 * t}
                for t in range(4)]
        covered = set()
        for coords in itertools.product(*[range(n) for n in mesh[0]]):
            rank = dataclasses.replace(info, coords=coords)
            spec, rows = batch_shardings(get_config(arch), shape, rank)(leaf)
            assert spec == norm(jspec, 2)
            assert rows.stop - rows.start == local
            covered |= set(range(rows.start, rows.stop))
            got = list(sharded_batches(iter(host), get_config(arch), shape,
                                       rank, prefetch=2, device="cpu"))
            assert len(got) == len(host)
            for b, h in zip(got, host):
                assert np.array_equal(b["tokens"].numpy(), h["tokens"][rows])
        assert covered == set(range(batch))
