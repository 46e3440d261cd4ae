"""Declarative parameter specs (port of ``repro/models/param.py``).

A model declares its parameters as a dict of ``ParamSpec``, flat (the
two-tower model) or nested (the transformer: ``layers/attn/wq`` with a
leading layer axis); ``init_params`` turns it into a dict of the same
shape holding tensors. Random state is an explicit ``torch.Generator``: a
JAX key of the same seed gives other numbers, so tests carry the JAX
leaves across with ``repro_torch.convert`` instead. The logical sharding
axes are kept for the sharded slice (ROADMAP.md queue 1, slice 11) and are
unused on one card.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import device as _device


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | eye
    scale: float | None = None  # None → 1/sqrt(fan_in)
    dtype: Any = None           # None → the model's param dtype


def _init_one(generator: torch.Generator, spec: ParamSpec, default_dtype,
              dev: torch.device) -> torch.Tensor:
    dtype = spec.dtype or default_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "eye":
        eye = torch.eye(spec.shape[-1], dtype=dtype, device=dev)
        return eye.expand(spec.shape).clone()
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    z = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return z.mul_(scale).to(dtype)


def init_params(generator: torch.Generator, specs: dict,
                param_dtype=torch.float32, *, device=None) -> dict:
    """One tensor per spec of a (nested) dict, drawn in sorted key order at
    every level (the JAX package's tree order) on ``device`` (the card by
    default). An ``eye`` spec with a leading layer axis is the identity on
    every layer."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)

    def init(tree: dict) -> dict:
        return {name: (init(tree[name]) if isinstance(tree[name], dict)
                       else _init_one(generator, tree[name], param_dtype,
                                      dev))
                for name in sorted(tree)}

    return init(specs)


def count_params(specs: dict) -> int:
    """Parameters in a (nested) dict of specs."""
    return sum(count_params(s) if isinstance(s, dict) else math.prod(s.shape)
               for s in specs.values())
