"""IVF index build: coarse quantizer + residual PQ or RQ in a block-aligned
CSR, and its partitioned forms (port of ``repro/index/ivf.py``).

A ``VQ`` coarse quantizer over the rotated vectors XR partitions the corpus
into ``num_lists`` inverted lists, and a ``PQ`` (depth 1) or a depth-M
``RQ`` encodes the residual x·R − c(x). Scores decompose as ⟨q·R, c_l⟩ +
Σ_p LUT[p, code_p] over the Dp = M·D code columns.

Layout: ``codes (cap, Dp)`` uint8 and ``ids (cap,)`` int32, all lists
concatenated; ``list_offsets (L+1,)`` int32, every offset a multiple of
``block_size`` so a list is a whole number of scan tiles; holes carry
id −1, and one all-hole sentinel block ends the array as the target of
out-of-range tiles of short lists.

Partitioned: ``shard_split`` repartitions a built index into per-shard
CSRs by id rank, carrying the codes; ``build_sharded`` builds one per
corpus chunk from one shared fit. Both feed ``search.attach_shards``.
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
    quantizer: quant.PQ | quant.RQ  # residual quantizer
    codes: torch.Tensor         # (cap, Dp) uint8, CSR by list
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


def encode(XR: torch.Tensor, coarse: quant.VQ, quantizer
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """List ids (m,) int32 and residual codes (m, Dp) int32 of already
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


def pack(R: torch.Tensor, coarse: quant.VQ, quantizer,
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
    corpus is always encoded. ``cfg.depth > 1`` fits a residual ``RQ``,
    whose codes are M·D bytes a row. ``generator`` must live on
    ``device``."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
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


# ---------------------------------------------------------------------------
# Partitioned build: the corpus lives sharded, each shard a local CSR
# ---------------------------------------------------------------------------


def shard_split(index: IVFPQIndex, num_shards: int) -> list[IVFPQIndex]:
    """Repartition a built index into ``num_shards`` per-shard CSRs.

    Shard s owns the s-th of S equal slices of the sorted live ids (by id
    rank, not value: sparse external ids stay balanced within one row);
    every shard keeps the shared R, coarse and residual quantizer and
    repacks its own rows into block-aligned lists. Codes are carried, never
    re-encoded, so a shard's row scores are the source index's bit for
    bit. The parts stay on the index's device."""
    ids = index.ids.cpu().numpy()
    codes = index.codes.cpu().numpy()
    offsets = index.list_offsets.cpu().numpy()
    live = ids >= 0
    row_list = np.searchsorted(offsets, np.arange(len(ids)), side="right") - 1
    row_list = np.clip(row_list, 0, index.num_lists - 1)
    live_ids = ids[live]
    rank = np.empty(live_ids.size, dtype=np.int64)
    rank[np.argsort(live_ids, kind="stable")] = np.arange(live_ids.size)
    shard_of = np.full(ids.shape, -1, dtype=np.int64)
    shard_of[live] = (rank * num_shards) // max(live_ids.size, 1)
    parts = []
    for s in range(num_shards):
        m = shard_of == s
        parts.append(pack(index.R, index.coarse, index.quantizer,
                          torch.from_numpy(codes[m]),
                          torch.from_numpy(row_list[m]),
                          torch.from_numpy(ids[m]),
                          block_size=index.block_size))
    return parts


#: Training rows ``build_sharded`` samples when ``train_size`` is None.
SHARDED_TRAIN_ROWS = 65536


def build_sharded(generator: torch.Generator, chunks, R: torch.Tensor,
                  cfg: IVFPQConfig, *, coarse_iters: int = 10,
                  pq_iters: int = 10, train_size: int | None = None,
                  mesh=None, axis: str = "data",
                  device=None) -> list[IVFPQIndex]:
    """Chunked ingest: one local index per corpus chunk.

    ``chunks`` is a sequence of (rows_s, n) tensors or arrays, one a shard,
    rotated and encoded one at a time on ``device`` (the card by default),
    so the whole corpus never sits there at once. The one cross-chunk state
    is the training sample, the chunks' heads up to ``train_size`` rows
    (SHARDED_TRAIN_ROWS by default, never the whole corpus), and the
    quantizers fitted on it. Item ids are global, in chunk order. With a
    ``mesh`` the coarse fit is ``quant.kmeans.vq_kmeans_sharded`` over it;
    the residual fit runs on the sample either way. Returns the per-shard
    indexes for ``search.attach_shards``."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    R = R.to(dev, torch.float32)

    def rows(c) -> torch.Tensor:
        if not isinstance(c, torch.Tensor):
            c = torch.from_numpy(np.asarray(c, dtype=np.float32))
        return c.to(dev, torch.float32)

    n_total = sum(int(c.shape[0]) for c in chunks)
    cap = min(SHARDED_TRAIN_ROWS if train_size is None else train_size,
              n_total)
    sample, have = [], 0
    for c in chunks:
        if have >= cap:
            break
        take = min(int(c.shape[0]), cap - have)
        sample.append(rows(c[:take]) @ R)
        have += take
    XT = torch.cat(sample) if len(sample) > 1 else sample[0]
    if mesh is not None:
        coarse = quant.VQ(quant.kmeans.vq_kmeans_sharded(
            generator, XT, cfg.num_lists, mesh=mesh, axis=axis,
            iters=coarse_iters).to(dev))
    else:
        coarse = quant.VQ.fit(generator, XT, cfg.num_lists,
                              iters=coarse_iters)
    train_lists = coarse.assign(XT).long()
    quantizer, _ = quant.fit_quantizer(
        generator, XT - coarse.centroids[train_lists], cfg.pq,
        depth=cfg.depth, iters=pq_iters)
    del XT, sample

    parts, start = [], 0
    for c in chunks:
        m = int(c.shape[0])
        list_ids, codes = encode(rows(c) @ R, coarse, quantizer)
        ids = torch.arange(start, start + m, dtype=torch.int32)
        start += m
        parts.append(pack(R, coarse, quantizer, codes, list_ids, ids,
                          block_size=cfg.block_size))
    return parts
