"""The port stands alone: no file under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``repro`` (an AST scan of
every import, including ones inside functions); the package imports in a
process where ``jax`` and ``repro`` cannot be imported; and its entry
points refuse to run on the CPU unless asked to."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config import FLConfig
from repro_torch.configs.paper_models import LOGREG_SYN
from repro_torch.core.simulator import Simulator
from repro_torch.data.federated import pack_clients
from repro_torch.data.synthetic import syncov
from repro_torch.protocols import get
from repro_torch.protocols.engine import DenseEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    data = pack_clients(*syncov(num_clients=6, seed=0), 10, seed=0)
    fl = FLConfig(num_clients=6, num_clusters=2, devices_per_cluster=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(LOGREG_SYN, data, fl)
    sim = Simulator(LOGREG_SYN, data, fl, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseEngine(LOGREG_SYN, sim.data_dev, fl, get("fedp2p"))
