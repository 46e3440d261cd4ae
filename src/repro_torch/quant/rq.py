"""RQ — depth-M residual product quantizer (port of ``repro/quant/rq.py``).

Level 0 product-quantizes the vector; each further level quantizes the
residual the levels before it leave. The reconstruction is the sum of the
level decodes, so the ADC score stays one table sum over ``code_width =
M·D`` columns, ⟨q, x̂⟩ = Σ_{l,d} LUT[l·D + d, c_{l,d}]: to the scan kernels
an RQ is a PQ with M·D subspaces.

Codes are stored level-major: column l·D + d holds level l, subspace d.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant import codebook as cb
from repro_torch.quant import kmeans as km
from repro_torch.quant.base import PQConfig


@dataclasses.dataclass(frozen=True)
class RQ:
    """Residual quantizer over ``codebooks (M, D, K, sub)``."""

    codebooks: torch.Tensor

    @property
    def num_levels(self) -> int:
        return self.codebooks.shape[0]

    @property
    def num_subspaces(self) -> int:
        return self.codebooks.shape[1]

    @property
    def num_codewords(self) -> int:
        return self.codebooks.shape[2]

    @property
    def sub(self) -> int:
        return self.codebooks.shape[3]

    @property
    def dim(self) -> int:
        return self.num_subspaces * self.sub

    @property
    def code_width(self) -> int:
        return self.num_levels * self.num_subspaces

    @property
    def code_dtype(self) -> torch.dtype:
        """Storage dtype of the codes: uint8 up to 256 codewords."""
        return torch.uint8 if self.num_codewords <= 256 else torch.int32

    @property
    def config(self) -> PQConfig:
        return PQConfig(self.num_subspaces, self.num_codewords)

    @classmethod
    def fit(cls, generator: torch.Generator, X: torch.Tensor, cfg: PQConfig,
            depth: int, iters: int = 10) -> tuple["RQ", torch.Tensor]:
        """Greedy level-by-level fit: k-means of each level on the residual
        the levels before it leave -> (RQ, (depth, iters) distortion trace,
        each level's of the residual it sees). The levels draw their
        initial rows one after another from ``generator``."""
        res = X
        cbs, traces = [], []
        for _ in range(depth):
            level_cb, tr = km.kmeans(generator, res, cfg, iters=iters)
            res = res - cb.quantize(res, level_cb)
            cbs.append(level_cb)
            traces.append(tr)
        return cls(torch.stack(cbs)), torch.stack(traces)

    def encode(self, X: torch.Tensor) -> torch.Tensor:
        """(m, n) -> (m, M·D) int32, level-major: greedy residual encoding,
        each level through ``codebook.assign`` on what is left."""
        res = X
        cols = []
        for lvl in range(self.num_levels):
            codes_l = cb.assign(res, self.codebooks[lvl])
            res = res - cb.decode(codes_l, self.codebooks[lvl])
            cols.append(codes_l)
        return torch.cat(cols, dim=-1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(m, M·D) -> (m, n): the sum of the levels' reconstructions."""
        D = self.num_subspaces
        out = cb.decode(codes[..., :D], self.codebooks[0])
        for lvl in range(1, self.num_levels):
            out = out + cb.decode(codes[..., lvl * D:(lvl + 1) * D],
                                  self.codebooks[lvl])
        return out

    def encode_st(self, X: torch.Tensor) -> torch.Tensor:
        """decode(encode(X)) forward, the identity backward wrt X."""
        with torch.no_grad():
            q = self.decode(self.encode(X))
        return X + (q - X.detach())

    def adc_tables(self, Q: torch.Tensor) -> torch.Tensor:
        """(b, n) -> (b, M·D, K): the levels' tables, level-major, so the
        scan kernels see one wide PQ."""
        return torch.cat([cb.adc_lut(Q, self.codebooks[lvl])
                          for lvl in range(self.num_levels)], dim=1)

    def lut_operands(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Operands of the fused LUT build (``kernels.ops.fused_lut``): the
        codebooks flattened level-major to (M·D, K, sub), as the code
        columns lie, and the one-hot map (M·D, D) sending column l·D + d to
        query subspace d (every level reads the same query slice)."""
        M, D, K, sub = self.codebooks.shape
        cols = torch.arange(M * D, device=self.codebooks.device)
        colmap = torch.zeros((M * D, D), dtype=torch.float32,
                             device=self.codebooks.device)
        colmap[cols, cols % D] = 1.0
        return self.codebooks.reshape(M * D, K, sub), colmap

    def distortion(self, X: torch.Tensor,
                   codes: torch.Tensor | None = None) -> torch.Tensor:
        """(1/m)‖X − decode(codes)‖²_F; the codes carry no gradient."""
        if codes is None:
            codes = self.encode(X.detach())
        q = self.decode(codes)
        return torch.mean(torch.sum(torch.square(X - q), dim=-1))

    def rotate(self, pi: torch.Tensor, pj: torch.Tensor,
               theta: torch.Tensor) -> "RQ":
        """Within-subspace plane rotations commute with the residual
        recursion (the residuals rotate with the data), so one call over
        the (M·K, n) codeword rows refreshes every level. The caller zeroes
        θ on cross-subspace pairs."""
        return RQ(cb.rotate_codebooks(self.codebooks, pi, pj, theta))
