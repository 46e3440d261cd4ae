"""Architecture registry (port of ``repro/configs``): ``get(arch_id)`` and
``REGISTRY`` over every architecture of the JAX registry, ``ASSIGNED`` and
the 40-cell dry-run grid ``grid_cells()``."""
from __future__ import annotations

from repro_torch.configs import (
    din,
    graphsage_reddit,
    grok_1_314b,
    llama4_maverick_400b,
    mind,
    nemotron_4_340b,
    olmo_1b,
    paper_twotower,
    qwen1_5_4b,
    two_tower_retrieval,
    wide_deep,
)
from repro_torch.configs.base import ArchSpec, Shape  # noqa: F401

_MODULES = [qwen1_5_4b, olmo_1b, nemotron_4_340b, grok_1_314b,
            llama4_maverick_400b, graphsage_reddit, wide_deep,
            two_tower_retrieval, mind, din, paper_twotower]

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}

# The 10 assigned architectures (paper-twotower is extra, not in the grid).
ASSIGNED = [a for a in REGISTRY if a != "paper-twotower"]


def get(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def grid_cells():
    """All (arch_id, shape_name) dry-run cells — the 40-cell grid."""
    cells = []
    for aid in ASSIGNED:
        for shape_name in REGISTRY[aid].shapes:
            cells.append((aid, shape_name))
    return cells
