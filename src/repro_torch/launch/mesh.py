"""The card a cell runs on (port of ``repro/launch/mesh.py``).

The card's numbers are owned by ``repro_torch.roofline.analysis`` and
re-exported here, so the dry run's capacity check and the roofline table
never disagree on what a chip is. ``make_host_mesh``'s counterpart is one
card; the production meshes (16×16 and 2×16×16 TPU chips) need the
sharded slice and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.roofline.analysis import (  # noqa: F401  (re-exports)
    CHIP_HBM_BYTES,
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_F32,
    num_chips,
)

SHARDED_LATER = ("production meshes (16x16, 2x16x16) need the sharded "
                 "slice on torch.distributed (ROADMAP.md queue 1, item 11)")


class Mesh(NamedTuple):
    """One device under the JAX mesh's axis names."""
    shape: dict
    device: torch.device
    name: str


def make_host_mesh(device=None) -> Mesh:
    """One card (the default) or the CPU, with the production axis names
    at size 1: the mesh every dry-run record of the port is measured on."""
    dev = _device.resolve(device)
    return Mesh(shape={"data": 1, "model": 1}, device=dev,
                name="1xH100" if dev.type == "cuda" else "1xCPU")


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(SHARDED_LATER)


def make_data_mesh(shards: int | None = None):
    raise NotImplementedError(SHARDED_LATER)
