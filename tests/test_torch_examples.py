"""The port's examples (``scripts/torch_*.py``, the counterparts of
``examples/*.py``) run end to end on the CPU at a reduced size with
``--device cpu``, in this process (``runpy``), and print what their JAX
examples print; without ``--device`` they target the card and raise where
there is none."""
import runpy
from pathlib import Path

import pytest
import torch

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models are tiny,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, capsys, name, *argv):
    monkeypatch.setattr("sys.argv", [name, *argv])
    runpy.run_path(str(SCRIPTS / name), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "torch_quickstart.py", "--device", "cpu",
               "--rounds", "2", "--clients", "20")
    best = next(line for line in out.splitlines()
                if line.startswith("best accuracy:"))
    for name in ("fedavg", "fedp2p", "gossip", "fedp2p_topo",
                 "gossip_async"):
        assert f"{name}=" in best
    assert "gossip_async matchings differ across draws: True" in out
    assert "speedup R=" in out


def test_serve_batched(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "torch_serve_batched.py", "--device",
               "cpu", "--batch", "2", "--prompt", "8", "--new-tokens", "3")
    for arch in ("qwen2-1.5b", "mamba2-130m", "hymba-1.5b"):
        assert f"{arch}: generated (2, 3)" in out


def test_train_lm(monkeypatch, capsys, tmp_path):
    out = _run(monkeypatch, capsys, "torch_train_lm.py", "--device", "cpu",
               "--steps", "6", "--batch", "2", "--seq-len", "32",
               "--ckpt-dir", str(tmp_path))
    assert "over 6 steps" in out.splitlines()[-1]
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_00000003.npz", "step_00000006.npz"]


def test_federated_lm(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "torch_federated_lm.py", "--device",
               "cpu", "--rounds", "2", "--local-steps", "1")
    last = out.strip().splitlines()[-1]
    assert last.startswith("final losses: fedp2p=") and "fedavg=" in last


def test_examples_default_to_the_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(monkeypatch, capsys, "torch_federated_lm.py", "--rounds", "1")
