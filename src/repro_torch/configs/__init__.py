"""Config registry of the port: ``get_config(arch_id)`` for the LM
architectures the port serves, and the paper nets (``PAPER_NETS``).

Arch ids use the dashed names of the JAX package's registry (e.g.
``hymba-1.5b``); module names use underscores. The other five
architectures of that registry raise ``NotImplementedError`` until their
families are ported (ROADMAP item 14).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs import (
    dbrx_132b, deepseek_v2_236b, hymba_1_5b, mamba2_130m, qwen2_1_5b,
)
from repro_torch.configs.paper_models import PAPER_NETS, PaperNetConfig  # noqa: F401

_MODULES = (qwen2_1_5b, mamba2_130m, hymba_1_5b, deepseek_v2_236b,
            dbrx_132b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
#: the JAX package's architectures that the port does not serve yet
NOT_PORTED = ("nemotron-4-15b", "gemma-2b", "yi-34b", "musicgen-medium",
              "chameleon-34b")
ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP item "
            f"14); ported: {sorted(REGISTRY)}")
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[key]
