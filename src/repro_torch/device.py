"""Device and random-state helpers shared by the port's entry points.

Every entry point that creates tensors takes ``device=`` with the card as
the default. ``resolve`` turns that argument into a ``torch.device`` and
refuses a CUDA device on a machine without one: the port never carries on
silently on the CPU. Random state is an explicit ``torch.Generator`` on the
same device, in place of the JAX package's PRNG keys.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point works on: ``device`` or the card.

    Raises RuntimeError for a CUDA device when no card is available — pass
    ``device="cpu"`` to run the plain PyTorch path on purpose."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev


def generator(seed: int, device: str | torch.device | None = None
              ) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the card by default)."""
    g = torch.Generator(device=resolve(device))
    g.manual_seed(int(seed))
    return g


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Raise if ``gen`` lives on another device type than ``device``."""
    if torch.device(gen.device).type != device.type:
        raise ValueError(
            f"generator is on {gen.device}, tensors are on {device}: make it "
            f"with repro_torch.device.generator(seed, device)")
