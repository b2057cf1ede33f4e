"""The port's ``DenseEngine`` against the JAX package's on the gossip
family and on the compressed wire, round for round with identical
randomness: each round's draws — the matching index of gossip_async and
the int8 codec's rounding noise included — are made from the JAX key tree
and handed to the port (``test_torch_engine.run_draws``).

* gossip and gossip_async x mix_path auto and dense x sync_period 1 and
  2: a T=3 ``run_rounds`` against ``repro.core.simulator.Simulator.run``
  at rtol 1e-4 / atol 1e-5, as the codec-free runs of
  ``test_torch_engine.py``;
* fedp2p and gossip x codec bf16, int8 and topk x mix_path auto and dense,
  T=3 (so topk's error-feedback residual is carried into two later
  rounds), at rtol 1e-5 / atol 1e-6. The two packages' training steps
  agree to a few ulp, and a one-ulp difference in a round delta could
  move it across a rounding boundary of the wire (an int8 step, a bf16
  step, a top-k tie) and then differ by that step in one coordinate. On
  these inputs no such flip happens: the worst relative difference of
  any metric measured over the twelve runs is 2.0e-7, the same as
  without a codec, so 1e-5 is the tightest round tolerance that holds
  with margin for another CPU's summation order.

Model and data as in ``test_torch_engine.py``: logreg on SynCov with
stragglers.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import protocols as jprotocols  # noqa: E402
from repro.config import FLConfig as JFLConfig  # noqa: E402
from repro.configs.paper_models import LOGREG_SYN as J_LOGREG  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs.paper_models import LOGREG_SYN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.data.federated import pack_clients  # noqa: E402
from repro_torch.data.synthetic import syncov  # noqa: E402
from test_torch_engine import LOGREG_FL, T, run_draws  # noqa: E402

TOL_EXACT = dict(rtol=1e-4, atol=1e-5)
TOL_WIRE = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def syncov_data():
    return pack_clients(*syncov(num_clients=20, seed=0), 10, seed=0)


def _run_both(data, algo, codec, kw):
    """(port metrics, JAX History) of a T-round run from the same initial
    weights and the same draws."""
    jsim = JSimulator(J_LOGREG, data, JFLConfig(**kw))
    hist = jsim.run(rounds=T, algorithm=algo, seed=0, codec=codec)
    sim = Simulator(LOGREG_SYN, data, FLConfig(**kw), device="cpu")
    engine = sim.engine(algo, codec=codec)
    int8 = None
    if isinstance(engine.codec, compression.Int8Codec):
        int8 = (engine.codec, sum(int(np.size(v)) for v in
                                  jax.tree.leaves(jsim.init_params(0))))
    draws = run_draws(jprotocols.get(algo), JFLConfig(**kw), 0, T,
                      data.y.shape[1], int8)
    params = params_from_jax(jax.tree.map(np.asarray, jsim.init_params(0)))
    _, m = engine.run_rounds(params, None, T, draws=draws)
    return m, hist


def _check(m, hist, tol):
    assert all(v.shape == (T,) for v in m.values())
    for k in ("train_loss", "acc", "acc_client_mean"):
        np.testing.assert_allclose(m[k].numpy().astype(np.float64),
                                   np.asarray(getattr(hist, k), np.float64),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("algo", ["gossip", "gossip_async"])
@pytest.mark.parametrize("mix_path", ["auto", "dense"])
@pytest.mark.parametrize("sync_period", [1, 2])
def test_gossip_run_rounds_match_jax(syncov_data, algo, mix_path,
                                     sync_period):
    kw = dict(LOGREG_FL, sync_period=sync_period, mix_path=mix_path)
    m, hist = _run_both(syncov_data, algo, None, kw)
    _check(m, hist, TOL_EXACT)


@pytest.mark.parametrize("algo", ["fedp2p", "gossip"])
@pytest.mark.parametrize("codec", ["bf16", "int8", "topk"])
@pytest.mark.parametrize("mix_path", ["auto", "dense"])
def test_codec_run_rounds_match_jax(syncov_data, algo, codec, mix_path):
    kw = dict(LOGREG_FL, mix_path=mix_path)
    m, hist = _run_both(syncov_data, algo, codec, kw)
    _check(m, hist, TOL_WIRE)
