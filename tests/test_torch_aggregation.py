"""The port's ``Aggregate(·)`` (``repro_torch.core.aggregation``) against
the JAX package's ``repro.core.aggregation``: ``weighted_average``,
``cluster_then_global`` and ``cluster_models`` on a stacked tree with f32
and bf16 leaves, with and without a mask, and every degenerate-round guard
(zero-weight survivors, an all-zero mask, a dead cluster, an empty
cluster). Tolerance rtol 1e-6 / atol 1e-7 on f32 leaves: the coefficients
are the same operations, and the weighted sums over the N rows are taken
in another order (XLA's reduction against the port's ``fed_aggregate``
plain version and ``torch.matmul``); bf16 leaves, rounded once from the
f32 sum, within one bf16 step. Through the port the reductions of
``weighted_average`` and ``cluster_then_global`` run ``fed_aggregate``
(on the CPU its plain version: the wrapper is asserted to be called).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import aggregation as jagg  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N, L = 7, 3


def _stacked(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((N, 4, 5)).astype(np.float32),
            "b": rng.standard_normal((N, 5)).astype(np.float32),
            "e": {"z": rng.standard_normal((N, 2, 3)).astype(np.float32)}}


def _port(tree, bf16_key):
    out = {k: (_port(v, bf16_key) if isinstance(v, dict)
               else torch.from_numpy(v)) for k, v in tree.items()}
    if bf16_key in out:
        out[bf16_key] = out[bf16_key].to(torch.bfloat16)
    return out


def _jax(tree, bf16_key):
    out = {k: (_jax(v, bf16_key) if isinstance(v, dict) else jnp.asarray(v))
           for k, v in tree.items()}
    if bf16_key in out:
        out[bf16_key] = out[bf16_key].astype(jnp.bfloat16)
    return out


def _compare(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _compare(got[k], v)
            continue
        g = got[k]
        assert tuple(g.shape) == tuple(v.shape), k
        if v.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(v, np.float32),
                                       rtol=2 ** -7, atol=1e-6, err_msg=k)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


CASES = {
    "plain": (np.arange(1.0, N + 1), None, [0, 1, 2, 0, 1, 2, 0]),
    "masked": (np.arange(1.0, N + 1), [1, 0, 1, 1, 0, 1, 1],
               [0, 1, 2, 0, 1, 2, 0]),
    # the survivors all have weight 0: uniform over the mask
    "zero_weight_survivors": ([0.0, 3, 0, 0, 2, 0, 0], [1, 0, 1, 1, 0, 1, 1],
                              [0, 0, 1, 1, 2, 2, 2]),
    # every client straggled: uniform over all clients
    "all_masked": (np.arange(1.0, N + 1), [0] * N, [0, 1, 2, 0, 1, 2, 0]),
    # cluster 1's members all straggled: it is left out of the mean
    "dead_cluster": (np.arange(1.0, N + 1), [1, 0, 1, 1, 0, 1, 1],
                     [0, 1, 2, 0, 1, 2, 0]),
    # cluster 2 has no member at all
    "empty_cluster": ([2.0, 1, 4, 1, 3, 5, 1], None, [0, 1, 0, 1, 0, 1, 0]),
    "all_zero_weights": ([0.0] * N, None, [0, 1, 2, 0, 1, 2, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bf16_key", ["", "b"])
def test_aggregation_matches_jax(case, bf16_key, monkeypatch):
    weights, mask, ids = CASES[case]
    tree = _stacked(len(case))
    w = np.asarray(weights, np.float32)
    ids = np.asarray(ids, np.int32)
    m = None if mask is None else np.asarray(mask, np.float32)
    tw, tids = torch.from_numpy(w), torch.from_numpy(ids)
    tm = None if m is None else torch.from_numpy(m)
    jw, jids = jnp.asarray(w), jnp.asarray(ids)
    jm = None if m is None else jnp.asarray(m)
    calls = []
    real = ops.fed_aggregate

    def counted(x, coef):
        calls.append(tuple(x.shape))
        return real(x, coef)

    monkeypatch.setattr(ops, "fed_aggregate", counted)
    _compare(aggregation.weighted_average(_port(tree, bf16_key), tw, tm),
             jagg.weighted_average(_jax(tree, bf16_key), jw, jm))
    _compare(aggregation.cluster_then_global(_port(tree, bf16_key), tw, tids,
                                             L, tm),
             jagg.cluster_then_global(_jax(tree, bf16_key), jw, jids, L, jm))
    _compare(aggregation.cluster_models(_port(tree, bf16_key), tw, tids, L,
                                        tm),
             jagg.cluster_models(_jax(tree, bf16_key), jw, jids, L, jm))
    # one packed [N, sum(sizes)] pass each for the two global reductions
    assert calls == [(N, 20 + 5 + 6)] * 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_normalize_guards(case):
    weights, mask, _ = CASES[case]
    w = torch.tensor(weights, dtype=torch.float32)
    m = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    coef = aggregation._normalize(w, m)
    want = jagg._normalize(jnp.asarray(w.numpy()),
                           None if m is None else jnp.asarray(m.numpy()))
    np.testing.assert_allclose(coef.numpy(), np.asarray(want), rtol=1e-6)
    assert abs(float(coef.sum()) - 1.0) < 1e-6


def test_aggregate_of_other_float_dtypes_reduces_in_f32():
    """A float64 or float16 tree is reduced in f32 and cast back, as the
    JAX package reduces every leaf (``fed_aggregate`` takes f32 and bf16
    buffers)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6))
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    for dt in (torch.float64, torch.float16):
        got = aggregation.weighted_average({"x": torch.from_numpy(x).to(dt)},
                                           torch.from_numpy(w))["x"]
        assert got.dtype == dt
        want = (torch.from_numpy(x).to(dt).float()
                * torch.from_numpy(w)[:, None]).sum(0)
        torch.testing.assert_close(got.float(), want.to(dt).float(),
                                   rtol=1e-3, atol=1e-3)
