"""Lloyd's k-means for codebooks and coarse centroids (port of
``repro/quant/kmeans.py:29-108``, unsharded).

One implementation serves per-subspace PQ codebooks and, through
``vq_kmeans`` (one subspace), the IVF coarse centroids. Random state is an
explicit ``torch.Generator`` on the data's device.
"""
from __future__ import annotations

import torch

from repro_torch.quant.base import PQConfig
from repro_torch.quant.codebook import assign, distortion, split


def kmeans_init(generator: torch.Generator, X: torch.Tensor,
                cfg: PQConfig) -> torch.Tensor:
    """Codebooks from K distinct sampled rows per subspace: (D, K, sub)."""
    m = X.shape[0]
    if cfg.num_codewords > m:
        raise ValueError(f"k-means needs at least K={cfg.num_codewords} "
                         f"rows, got {m}")
    idx = torch.randperm(m, generator=generator,
                         device=X.device)[:cfg.num_codewords]
    return split(X[idx], cfg.num_subspaces).transpose(0, 1).contiguous()


def kmeans_update(X: torch.Tensor, codebooks: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over all D subspaces -> (codebooks, codes).
    Empty clusters keep their previous centroid."""
    D, K, sub = codebooks.shape
    codes = assign(X, codebooks)                                   # (m, D)
    seg = (codes.long()
           + torch.arange(D, device=X.device) * K).reshape(-1)     # (m·D,)
    rows = split(X, D).reshape(-1, sub)                            # (m·D, sub)
    sums = torch.zeros((D * K, sub), dtype=X.dtype, device=X.device)
    sums.index_add_(0, seg, rows)
    cnt = torch.zeros((D * K,), dtype=torch.float32, device=X.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))
    sums = sums.view(D, K, sub)
    cnt = cnt.view(D, K, 1)
    new = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), codebooks)
    return new, codes


def kmeans(generator: torch.Generator, X: torch.Tensor, cfg: PQConfig,
           iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means per subspace -> (codebooks, distortion trace (iters,))."""
    cb = kmeans_init(generator, X, cfg)
    trace = []
    for _ in range(iters):
        cb, codes = kmeans_update(X, cb)
        trace.append(distortion(X, cb, codes))
    return cb, torch.stack(trace) if trace else torch.zeros((0,))


def vq_kmeans(generator: torch.Generator, X: torch.Tensor, num_centroids: int,
              iters: int = 10) -> torch.Tensor:
    """Full-vector k-means: (L, n) centroids, the IVF coarse fit."""
    cb, _ = kmeans(generator, X, PQConfig(1, num_centroids), iters=iters)
    return cb[0]
