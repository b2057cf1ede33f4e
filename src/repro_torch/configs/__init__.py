"""Config registry of the port: ``get_config(arch_id)`` for the ten LM
architectures of the JAX package's registry, ``get_shape(shape_id)`` for
its four input shapes (``SHAPES``), and the paper nets (``PAPER_NETS``).

Arch ids use the dashed names of the JAX package's registry (e.g.
``hymba-1.5b``); module names use underscores.
"""
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs import (
    chameleon_34b, dbrx_132b, deepseek_v2_236b, gemma_2b, hymba_1_5b,
    mamba2_130m, musicgen_medium, nemotron_4_15b, qwen2_1_5b, yi_34b,
)
from repro_torch.configs.paper_models import PAPER_NETS, PaperNetConfig  # noqa: F401
from repro_torch.configs.shapes import SHAPES

_MODULES = (
    nemotron_4_15b, qwen2_1_5b, gemma_2b, yi_34b, dbrx_132b,
    musicgen_medium, mamba2_130m, chameleon_34b, deepseek_v2_236b, hymba_1_5b,
)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[key]


def get_shape(shape: str) -> ShapeConfig:
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; available: "
                       f"{sorted(SHAPES)}")
    return SHAPES[shape]
