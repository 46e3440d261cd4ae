"""IVF index build: coarse quantizer + residual PQ in a block-aligned CSR
(port of ``repro/index/ivf.py:47-216``).

A ``VQ`` coarse quantizer over the rotated vectors XR partitions the corpus
into ``num_lists`` inverted lists, and a ``PQ`` encodes the residual
x·R − c(x). Scores decompose as ⟨q·R, c_l⟩ + Σ_d LUT[d, code_d].

Layout: ``codes (cap, D)`` uint8 and ``ids (cap,)`` int32, all lists
concatenated; ``list_offsets (L+1,)`` int32, every offset a multiple of
``block_size`` so a list is a whole number of scan tiles; holes carry
id −1, and one all-hole sentinel block ends the array as the target of
out-of-range tiles of short lists.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import quant

#: Rows encoded per chunk by ``encode`` (bounds the temporaries at 1M rows).
ENCODE_ROWS = 65536


class IVFPQConfig(NamedTuple):
    """Static build parameters (see the JAX package's IVFPQConfig)."""

    num_lists: int
    pq: quant.PQConfig
    block_size: int = 128
    depth: int = 1
    lut_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class IVFPQIndex:
    """Servable IVF-PQ index; every tensor lives on one device."""

    R: torch.Tensor             # (n, n) learned rotation
    coarse: quant.VQ            # L centroids in the rotated space
    quantizer: quant.PQ         # residual product quantizer
    codes: torch.Tensor         # (cap, D) uint8, CSR by list
    ids: torch.Tensor           # (cap,) int32, −1 = hole
    list_offsets: torch.Tensor  # (L+1,) int32, multiples of block_size
    block_size: int = 128

    @property
    def centroids(self) -> torch.Tensor:
        return self.coarse.centroids

    @property
    def codebooks(self) -> torch.Tensor:
        return self.quantizer.codebooks

    @property
    def num_lists(self) -> int:
        return self.coarse.num_centroids

    @property
    def dim(self) -> int:
        return self.coarse.dim

    @property
    def capacity(self) -> int:
        """Total CSR rows, padding and the sentinel block included."""
        return self.codes.shape[0]

    @property
    def sentinel_block(self) -> int:
        return self.capacity // self.block_size - 1

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def num_items(self) -> int:
        return int(torch.sum(self.ids >= 0))

    def max_list_blocks(self) -> int:
        """Longest list in blocks: the probe window of search (one host
        sync on the offsets)."""
        lens = np.diff(self.list_offsets.cpu().numpy())
        return max(int(lens.max()) // self.block_size, 1)


def encode(XR: torch.Tensor, coarse: quant.VQ,
           quantizer: quant.PQ) -> tuple[torch.Tensor, torch.Tensor]:
    """List ids (m,) int32 and residual codes (m, D) int32 of already
    rotated vectors, in chunks of ``ENCODE_ROWS`` rows."""
    m = XR.shape[0]
    lists = torch.empty((m,), dtype=torch.int32, device=XR.device)
    codes = torch.empty((m, quantizer.code_width), dtype=torch.int32,
                        device=XR.device)
    for s in range(0, m, ENCODE_ROWS):
        xr = XR[s:s + ENCODE_ROWS]
        li = coarse.assign(xr)
        lists[s:s + ENCODE_ROWS] = li
        codes[s:s + ENCODE_ROWS] = quantizer.encode(
            xr - coarse.centroids[li.long()])
    return lists, codes


def pack(R: torch.Tensor, coarse: quant.VQ, quantizer: quant.PQ,
         codes: torch.Tensor, list_ids: torch.Tensor, ids: torch.Tensor,
         block_size: int = 128) -> IVFPQIndex:
    """Lay encoded items out in block-aligned CSR order (host-side numpy,
    as in the JAX package); the index lands on ``R``'s device. Each list is
    padded to a multiple of ``block_size`` with hole rows (id −1, code 0)
    and a sentinel all-hole block is appended."""
    list_ids = list_ids.cpu().numpy().astype(np.int64)
    codes = codes.cpu().numpy()
    ids = ids.cpu().numpy().astype(np.int32)
    L = coarse.num_centroids
    Dp = codes.shape[1]

    counts = np.bincount(list_ids, minlength=L)
    padded = -(-counts // block_size) * block_size
    offsets = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(padded, out=offsets[1:])
    cap = int(offsets[-1]) + block_size

    codes_out = np.zeros((cap, Dp), dtype=quantizer.config.code_dtype())
    ids_out = np.full((cap,), -1, dtype=np.int32)

    order = np.argsort(list_ids, kind="stable")
    sorted_lists = list_ids[order]
    run_starts = np.zeros(L, dtype=np.int64)
    np.cumsum(counts[:-1], out=run_starts[1:])
    ranks = np.arange(len(order)) - run_starts[sorted_lists]
    dest = offsets[sorted_lists] + ranks
    codes_out[dest] = codes[order]
    ids_out[dest] = ids[order]

    dev = R.device
    return IVFPQIndex(
        R=R, coarse=coarse, quantizer=quantizer,
        codes=torch.from_numpy(codes_out).to(dev),
        ids=torch.from_numpy(ids_out).to(dev),
        list_offsets=torch.from_numpy(offsets).to(dev),
        block_size=block_size)


def build(generator: torch.Generator, X: torch.Tensor, R: torch.Tensor,
          cfg: IVFPQConfig, *, ids: torch.Tensor | None = None,
          coarse_iters: int = 10, pq_iters: int = 10,
          train_size: int | None = None, device=None) -> IVFPQIndex:
    """Index build from raw vectors and a learned rotation on ``device``
    (the card by default). ``train_size`` caps the k-means sample; the whole
    corpus is always encoded. ``generator`` must live on ``device``."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    if cfg.depth > 1:
        raise NotImplementedError(quant.RQ_LATER)
    X = X.to(dev)
    R = R.to(dev, X.dtype)
    XR = X @ R
    XT = XR if train_size is None else XR[:train_size]
    coarse = quant.VQ.fit(generator, XT, cfg.num_lists, iters=coarse_iters)
    train_lists = coarse.assign(XT).long()
    quantizer, _ = quant.fit_quantizer(
        generator, XT - coarse.centroids[train_lists], cfg.pq,
        depth=cfg.depth, iters=pq_iters)
    list_ids, codes = encode(XR, coarse, quantizer)
    del XR
    if ids is None:
        ids = torch.arange(X.shape[0], dtype=torch.int32)
    return pack(R, coarse, quantizer, codes, list_ids, ids,
                block_size=cfg.block_size)
