"""Architecture registry (port of ``repro/configs``) over the families
ported so far: ``get(arch_id)`` and ``REGISTRY``."""
from __future__ import annotations

from repro_torch.configs import (
    nemotron_4_340b,
    olmo_1b,
    paper_twotower,
    qwen1_5_4b,
)
from repro_torch.configs.base import ArchSpec, Shape  # noqa: F401

_MODULES = [qwen1_5_4b, olmo_1b, nemotron_4_340b, paper_twotower]

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown or unported arch {arch_id!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]
