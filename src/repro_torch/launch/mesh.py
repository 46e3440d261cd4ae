"""The card a cell runs on, and the serving mesh of the row-sharded
searchers (port of ``repro/launch/mesh.py``).

The card's numbers are owned by ``repro_torch.roofline.analysis`` and
re-exported here, so the dry run's capacity check and the roofline table
never disagree on what a chip is. ``make_host_mesh``'s counterpart is one
card. The production meshes are the JAX shapes, (16, 16) as ("data",
"model") and (2, 16, 16) as ("pod", "data", "model"): ``AbstractMesh``
carries their axis sizes and no devices, so sharding rules resolve
against them with nothing allocated (the dry run's reckoning), and
``make_production_mesh`` lays them over devices the caller names.

A ``DataMesh`` is named axes over an explicit tuple of shard devices, one
process driving them all (the JAX package's single-controller
``shard_map``): shard ``s`` lives on ``devices[s]``, in row-major order of
the axes. ``make_data_mesh`` lays one shard on each visible card unless
the caller names the devices; several shards on one card, or on the CPU,
are asked for by name (``devices=("cuda:0",) * 4``), never stacked
because cards are missing.
"""
from __future__ import annotations

import math
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

#: the production meshes: name -> (axis sizes, axis names)
PRODUCTION_MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


class Mesh(NamedTuple):
    """One device under the JAX mesh's axis names."""
    shape: dict
    device: torch.device
    name: str

    @property
    def devices(self) -> tuple:
        return (self.device,)


class AbstractMesh(NamedTuple):
    """Named axes and their sizes, no devices (``jax.sharding
    .AbstractMesh``): what rule resolution and the dry run's per-device
    reckoning read."""
    shape: dict
    name: str

    @property
    def devices(self):
        return None


def abstract_mesh(shape, axes) -> AbstractMesh:
    shape, axes = tuple(int(v) for v in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name {axes}")
    return AbstractMesh(shape=dict(zip(axes, shape)),
                        name="x".join(str(v) for v in shape))


def production_mesh_name(multi_pod: bool = False) -> str:
    return "2x16x16" if multi_pod else "16x16"


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes without devices."""
    return abstract_mesh(*PRODUCTION_MESHES[production_mesh_name(multi_pod)])


def make_host_mesh(device=None) -> Mesh:
    """One card (the default) or the CPU, with the production axis names
    at size 1: the mesh every dry-run record of the port is measured on."""
    dev = _device.resolve(device)
    return Mesh(shape={"data": 1, "model": 1}, device=dev,
                name="1xH100" if dev.type == "cuda" else "1xCPU")


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """The JAX production mesh, (16, 16) as ("data", "model") or (2, 16,
    16) as ("pod", "data", "model"), over ``devices`` (one a shard,
    row-major: ``("cuda:0",) * 256`` lays every shard on one card). With
    no devices it takes one visible card a shard and raises when there
    are fewer cards, as ``make_data_mesh`` does: 256 or 512 cards need
    the multi-process backend (ROADMAP.md queue 1, item 11b)."""
    shape, axes = PRODUCTION_MESHES[production_mesh_name(multi_pod)]
    if devices is None:
        n, cards = math.prod(shape), torch.cuda.device_count()
        if cards < n:
            raise ValueError(
                f"the {production_mesh_name(multi_pod)} mesh has {n} shards "
                f"but {cards} visible card(s): name the devices "
                f"(devices=('cuda:0',) * {n}); more cards need ROADMAP.md "
                "queue 1, item 11b")
    return make_mesh_compat(shape, axes, devices=devices)


class DataMesh(NamedTuple):
    """Named axes over the shard devices: ``shape`` maps each axis to its
    size, ``devices`` holds one device a shard (their product of sizes)."""
    shape: dict
    devices: tuple
    name: str


def _mesh_name(devices: tuple) -> str:
    kinds = {"cuda": "H100", "cpu": "CPU"}
    cards = sorted({str(d) for d in devices})
    where = "+".join(cards) if len(cards) > 1 else cards[0]
    return f"{len(devices)}x{kinds.get(devices[0].type, devices[0].type)}" \
        f"@{where}"


def make_mesh_compat(shape, axes, *, devices=None) -> DataMesh:
    """A mesh of ``axes`` with ``shape`` sizes (the JAX package's
    ``make_mesh_compat``, e.g. ``((2, 4), ("pod", "data"))``) over
    ``devices``, one a shard in row-major order; by default one visible
    card a shard, raising when there are fewer cards than shards."""
    shape, axes = tuple(int(v) for v in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name {axes}")
    n = math.prod(shape)
    devs = _shard_devices(n, devices)
    return DataMesh(shape=dict(zip(axes, shape)), devices=devs,
                    name=_mesh_name(devs))


def normal_device(device) -> torch.device:
    """A named device with its card index (``cuda`` is the current card),
    so shards on one card compare equal to its tensors' device."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _shard_devices(shards: int | None, devices) -> tuple:
    if devices is not None:
        devs = tuple(normal_device(d) for d in devices)
        if shards is not None and shards != len(devs):
            raise ValueError(f"{shards} shards over {len(devs)} named "
                             "devices")
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return devs
    _device.resolve(None)          # raises without a card
    cards = torch.cuda.device_count()
    shards = cards if shards is None else int(shards)
    if shards > cards:
        raise ValueError(
            f"{shards} shards but {cards} visible card(s): name the devices "
            f"to lay several shards on one card (devices=('cuda:0',) * "
            f"{shards}); more cards need ROADMAP.md queue 1, item 11b")
    if shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {shards}")
    return tuple(torch.device("cuda", i) for i in range(shards))


def make_data_mesh(shards: int | None = None, *, devices=None) -> DataMesh:
    """1-axis ``("data",)`` mesh: the serving mesh of the row-sharded
    searchers. One shard a visible card by default; ``devices`` names
    them (``("cuda:0",) * 4`` lays four shards on one card, ``("cpu",) *
    8`` eight on the CPU). Raises when ``shards`` exceeds the cards and no
    devices were named."""
    devs = _shard_devices(shards, devices)
    return DataMesh(shape={"data": len(devs)}, devices=devs,
                    name=_mesh_name(devs))
