"""The port's numpy copies of the data generators give the JAX package's
arrays exactly (``np.array_equal``) for a seed."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")       # repro.data's package imports JAX modules
from repro.data import federated as jfed  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _equal_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _equal_datasets(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("gen", ["syncov", "synlabel"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_generators_identical(gen, seed):
    jx, jy = getattr(jsyn, gen)(num_clients=12, seed=seed)
    tx, ty = getattr(tsyn, gen)(num_clients=12, seed=seed)
    _equal_lists(tx, jx)
    _equal_lists(ty, jy)


def test_pack_clients_identical():
    xs, ys = tsyn.syncov(num_clients=10, seed=1)
    _equal_datasets(tfed.pack_clients(xs, ys, 10, seed=2,
                                      max_per_client=30),
                    jfed.pack_clients(xs, ys, 10, seed=2, max_per_client=30))


@pytest.mark.parametrize("name,kwargs", [
    ("pseudo_femnist_federated", dict(num_clients=6, num_classes=62,
                                      seed=0)),
    ("pseudo_femnist_federated", dict(num_clients=5, per_client=20,
                                      num_classes=10, seed=4)),
    ("pseudo_mnist_federated", dict(num_clients=8, seed=1)),
    ("char_lm_federated", dict(num_clients=3, per_client=10, seq_len=12,
                               seed=2)),
])
def test_federated_generators_identical(name, kwargs):
    _equal_datasets(getattr(tfed, name)(**kwargs),
                    getattr(jfed, name)(**kwargs))
