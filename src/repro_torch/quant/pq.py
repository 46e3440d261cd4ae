"""PQ — single-level product quantizer (port of ``repro/quant/pq.py``).

Splits an n-dim vector into D contiguous subvectors and snaps each to the
nearest of K codewords; ``code_width == D``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant import codebook as cb
from repro_torch.quant import kmeans as km
from repro_torch.quant.base import PQConfig


@dataclasses.dataclass(frozen=True)
class PQ:
    """Product quantizer over ``codebooks (D, K, sub)``."""

    codebooks: torch.Tensor

    @property
    def num_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def num_codewords(self) -> int:
        return self.codebooks.shape[1]

    @property
    def sub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.codebooks.shape[0] * self.codebooks.shape[2]

    @property
    def code_width(self) -> int:
        return self.num_subspaces

    @property
    def code_dtype(self) -> torch.dtype:
        """Storage dtype of the codes: uint8 up to 256 codewords."""
        return torch.uint8 if self.num_codewords <= 256 else torch.int32

    @property
    def config(self) -> PQConfig:
        return PQConfig(self.num_subspaces, self.num_codewords)

    @classmethod
    def fit(cls, generator: torch.Generator, X: torch.Tensor, cfg: PQConfig,
            iters: int = 10) -> tuple["PQ", torch.Tensor]:
        """k-means per subspace -> (PQ, distortion trace (iters,))."""
        codebooks, trace = km.kmeans(generator, X, cfg, iters=iters)
        return cls(codebooks), trace

    def ema_update(self, X: torch.Tensor, codes: torch.Tensor,
                   decay: float = 0.99) -> "PQ":
        return PQ(km.codebook_ema_update(self.codebooks, X, codes,
                                         decay=decay))

    def encode(self, X: torch.Tensor) -> torch.Tensor:
        return cb.assign(X, self.codebooks)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return cb.decode(codes, self.codebooks)

    def encode_st(self, X: torch.Tensor) -> torch.Tensor:
        """φ(X) forward, identity backward wrt X (straight-through)."""
        return cb.quantize_ste(X, self.codebooks)

    def adc_tables(self, Q: torch.Tensor) -> torch.Tensor:
        return cb.adc_lut(Q, self.codebooks)  # (b, D, K)

    def lut_operands(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Operands of the fused LUT build (``kernels.ops.fused_lut``): the
        flattened codebooks (Dp, K, sub) and the one-hot code column ->
        query subspace map (Dp, D), the identity for PQ (Dp == D)."""
        D = self.num_subspaces
        return self.codebooks, torch.eye(D, dtype=torch.float32,
                                         device=self.codebooks.device)

    def distortion(self, X: torch.Tensor,
                   codes: torch.Tensor | None = None) -> torch.Tensor:
        return cb.distortion(X, self.codebooks, codes)

    def rotate(self, pi: torch.Tensor, pj: torch.Tensor,
               theta: torch.Tensor) -> "PQ":
        """Rotated-space refresh; the caller zeroes θ on cross-subspace
        pairs."""
        return PQ(cb.rotate_codebooks(self.codebooks, pi, pj, theta))
