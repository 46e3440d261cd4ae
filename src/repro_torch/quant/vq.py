"""VQ — full-vector quantizer, the IVF coarse quantizer (port of
``repro/quant/vq.py``). A PQ with D = 1: ``code_width == 1`` and the ADC
table is the plain centroid inner products Q·Cᵀ.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import givens
from repro_torch.quant import codebook as cb
from repro_torch.quant import kmeans as km


@dataclasses.dataclass(frozen=True)
class VQ:
    """Vector quantizer over ``centroids (L, n)``."""

    centroids: torch.Tensor

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_codewords(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def code_width(self) -> int:
        return 1

    @classmethod
    def fit(cls, generator: torch.Generator, X: torch.Tensor,
            num_centroids: int, iters: int = 10) -> "VQ":
        return cls(km.vq_kmeans(generator, X, num_centroids, iters=iters))

    def assign(self, X: torch.Tensor) -> torch.Tensor:
        """Nearest centroid: (m, n) -> (m,) int32, the IVF list id."""
        return cb.assign(X, self.centroids[None, ...])[:, 0]

    def encode(self, X: torch.Tensor) -> torch.Tensor:
        return self.assign(X)[:, None]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.centroids[codes.long()[..., 0]]

    def encode_st(self, X: torch.Tensor) -> torch.Tensor:
        """The nearest centroid forward, the identity backward wrt X."""
        with torch.no_grad():
            q = self.decode(self.encode(X))
        return X + (q - X.detach())

    def adc_tables(self, Q: torch.Tensor) -> torch.Tensor:
        return (Q @ self.centroids.T)[:, None, :]  # (b, 1, L)

    def distortion(self, X: torch.Tensor,
                   codes: torch.Tensor | None = None) -> torch.Tensor:
        if codes is None:
            codes = self.encode(X.detach())
        return torch.mean(torch.sum(torch.square(X - self.decode(codes)),
                                    dim=-1))

    def rotate(self, pi: torch.Tensor, pj: torch.Tensor,
               theta: torch.Tensor) -> "VQ":
        """Centroids live in the rotated space; any disjoint plane product
        applies exactly."""
        return VQ(givens.apply_pair_rotations(self.centroids, pi, pj, theta))
