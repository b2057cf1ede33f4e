"""``run_federated_training`` and ``python -m repro_torch.launch.train
--mode federated --device cpu`` against the JAX package's
``run_federated_training`` at the same seed, on the CPU: T 3 rounds at
JAX's cut (2 layers, width 128), 4 clients on their own token streams, the
same initial weights (JAX's, carried by ``lm_params_from_jax``: the
port's model init is replaced by them): mamba2-130m (the CLI's default arch),
fedp2p. Without stragglers, a matching or a noisy codec, no draw differs
between the two packages (the rounds' draws are held to JAX's in
``test_torch_mesh_engine.py``). The losses are held to 1e-3 relative: three rounds of SGD.
JAX's runs are made once a module."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.train import run_federated_training as jrun  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROUNDS = 3
CASES = {"cli": ("mamba2-130m", "fedp2p", "none")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(arch):
    cfg = jget_config(arch).reduced(num_layers=2, max_d_model=128)
    p = jbuild_model(cfg).init(jax.random.PRNGKey(0))
    return lm_params_from_jax(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def jax_runs():
    return {name: jrun(arch, rounds=ROUNDS, algorithm=algo, codec=codec,
                       verbose=False)
            for name, (arch, algo, codec) in CASES.items()}


@pytest.fixture
def jax_init(monkeypatch):
    """The port's model init replaced by JAX's weights."""
    params = _jax_params(CASES["cli"][0])
    build = train.build_model

    def with_jax_init(cfg):
        return dataclasses.replace(build(cfg), init=lambda *a, **k: params)

    monkeypatch.setattr(train, "build_model", with_jax_init)


def test_run_federated_training_matches_jax(jax_runs, jax_init):
    arch, algo, codec = CASES["cli"]
    out = train.run_federated_training(arch, rounds=ROUNDS, algorithm=algo,
                                       codec=codec, verbose=False,
                                       device="cpu")
    np.testing.assert_allclose(out["losses"], jax_runs["cli"]["losses"],
                               rtol=1e-3)
    assert out["final_loss"] == out["losses"][-1]


def test_federated_cli_matches_jax(jax_runs, jax_init, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--mode", "federated",
                                     "--rounds", str(ROUNDS), "--device",
                                     "cpu"])
    train.main()
    last = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert last[0] == "loss" and last[2] == "->"
    want = jax_runs["cli"]["losses"]
    np.testing.assert_allclose([float(last[1]), float(last[3])],
                               [want[0], want[-1]], rtol=1e-3)
