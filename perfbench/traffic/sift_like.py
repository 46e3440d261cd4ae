"""SIFT-like vectors: a frozen copy of ``repro_torch.data.synthetic.sift_like``.

A Gaussian mixture with a random orthogonal basis and log-spaced scales per
cluster. Corpus and queries come from one call, so they share the mixture.
The copy lives here so that a change to the program cannot change the
benchmark's inputs.
"""
from __future__ import annotations

import math

import torch


def sift_like(generator: torch.Generator, num: int, dim: int,
              num_clusters: int = 16, anisotropy: float = 8.0
              ) -> torch.Tensor:
    """(num, dim) float32 on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
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
