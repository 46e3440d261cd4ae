"""Synthetic vectors (port of ``repro/data/synthetic.py`` ``sift_like``).

A torch generator draws other numbers than a JAX key of the same seed, so
the port's data matches the JAX package's in distribution only.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as _device


def sift_like(generator: torch.Generator, num: int, dim: int,
              num_clusters: int = 16, anisotropy: float = 8.0, *,
              device=None) -> torch.Tensor:
    """Gaussian mixture with per-cluster anisotropic covariance, (num, dim)
    float32 on ``device`` (the card by default; ``generator`` must live
    there). Each cluster has a random orthogonal basis times log-spaced
    scales, like real SIFT's correlated coordinates.

    Rows are rotated cluster by cluster, one matmul each: the JAX version's
    per-row einsum against ``qs[assign]`` would hold a (num, dim, dim)
    tensor, 262 GB at num = 1M and dim = 256."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    kw = dict(generator=generator, device=dev)
    means = 4.0 * torch.randn((num_clusters, dim), **kw)
    u = torch.rand((num_clusters, dim), **kw) - 0.5
    scales = torch.exp(math.log(anisotropy) * u)
    qs, _ = torch.linalg.qr(torch.randn((num_clusters, dim, dim), **kw))
    assign = torch.randint(0, num_clusters, (num,), **kw)
    z = torch.randn((num, dim), **kw)
    out = torch.empty_like(z)
    for c in range(num_clusters):
        rows = torch.nonzero(assign == c).squeeze(1)
        out[rows] = (z[rows] * scales[c]) @ qs[c] + means[c]
    return out
