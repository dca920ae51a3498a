"""Architecture registry of the port.

``get_config(name)`` returns the full production config,
``get_config(name, reduced=True)`` the small same-family smoke config.
Ported so far: llama3.2-1b, mamba2-370m, granite-moe-1b-a400m and
zamba2-2.7b; the other architectures of the JAX registry arrive with their
slices (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.granite_moe_1b import CONFIG as granite_moe_1b
from repro_torch.configs.llama32_1b import CONFIG as llama32_1b
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.zamba2_27b import CONFIG as zamba2_27b
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [llama32_1b, mamba2_370m, granite_moe_1b,
                         zamba2_27b]}


def list_archs() -> List[str]:
    return list(ARCHS.keys())


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    cfg = ARCHS[name]
    return cfg.reduced() if reduced else cfg
