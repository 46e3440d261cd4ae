"""Architecture registry (port of ``repro/configs``) over the families
ported so far: ``get(arch_id)`` and ``REGISTRY``."""
from __future__ import annotations

from repro_torch.configs import (
    grok_1_314b,
    llama4_maverick_400b,
    nemotron_4_340b,
    olmo_1b,
    paper_twotower,
    qwen1_5_4b,
    two_tower_retrieval,
)
from repro_torch.configs.base import ArchSpec, Shape  # noqa: F401

_MODULES = [qwen1_5_4b, olmo_1b, nemotron_4_340b, grok_1_314b,
            llama4_maverick_400b, two_tower_retrieval, paper_twotower]

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown or unported arch {arch_id!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
