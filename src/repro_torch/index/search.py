"""Batched IVF-PQ search (port of ``repro/index/search.py``).

Per query batch (b, n):

  1. rotate:    QR = Q·R
  2. probe:     coarse scores QR·Cᵀ, keep the top-``nprobe`` lists; the
                product runs in chunks of PROBE_ROWS rows, so a query's
                coarse scores do not depend on its batch's size
  3. LUT build: ``quantizer.adc_tables(QR)``, optionally int8/uint8 packed
  4. scan:      the probed list tiles scored by the ``ivf_adc`` kernel; the
                coarse term ⟨q·R, c_l⟩ is added per (query, list) after it
  5. top-k:     over nprobe·max_blocks·block_size masked candidates

Every list is padded to whole ``block_size`` tiles, so each (query, list)
pair has a fixed window of ``max_blocks`` tiles; out-of-range tiles point at
the all-hole sentinel block, whose ids are −1 and score −inf.

The top-k follows the one contract of ``kernels.ref.topk_merge_ref``
(ties to the smaller id, (−inf, −1) padding). It first keeps, per row, the
candidates whose score reaches the row's k-th best finite score — a set
that holds every entry the contract can pick — and gathers ids for those
alone, so the two-key sort never runs over the full candidate pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.index.ivf import IVFPQIndex
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

#: Rows of every coarse product. cuBLAS picks its kernel, and with it the
#: order of the sums, by the shape of a product, so one product over a
#: whole batch could give a query other coarse scores in a batch of 37 rows
#: than in the Engine's padded bucket of 64, and rank a near tie the other
#: way. Products of one fixed shape make each query's scores its own.
PROBE_ROWS = 256

NEG_INF = float("-inf")


class SearchResult(NamedTuple):
    scores: torch.Tensor   # (b, k) approximate inner products, descending
    ids: torch.Tensor      # (b, k) int32 item ids (−1 past the pool)
    scanned: torch.Tensor  # (b,) CSR rows scanned per query


def _candidates(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (b, m), m ≥ min(k, C), that hold every candidate the top-k
    contract can select: all finite entries ≥ the row's k-th best score.
    Rows with fewer survivors are filled with other positions, which rank
    after them (lower or −inf scores)."""
    b, C = scores.shape
    kk = min(k, C)
    if C <= 4 * max(kk, 1):
        return torch.arange(C, device=scores.device).expand(b, C)
    thr = torch.topk(scores, kk, dim=1).values[:, -1:]
    keep = (scores >= thr) & torch.isfinite(scores)
    m = max(int(keep.sum(dim=1).max()), kk)
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    return torch.topk(masked, m, dim=1).indices


def topk_padded(scores: torch.Tensor, cand_ids: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k + padding contract every retrieval path shares.
    ``cand_ids`` is (C,) or (b, C); masked candidates already score −inf.
    Returns (b, k) scores and int32 ids padded with (−inf, −1)."""
    pos = _candidates(scores, k)
    ids = cand_ids[pos] if cand_ids.ndim == 1 else cand_ids.gather(1, pos)
    return kref.topk_merge_ref(scores.gather(1, pos), ids, k)


def build_luts(quantizer, QR: torch.Tensor, lut_dtype: str = "float32"):
    """ADC tables for rotated queries: a (b, Dp, K) float32 tensor, or a
    ``(qlut, scales)`` pack for ``lut_dtype`` int8/uint8."""
    lut = quantizer.adc_tables(QR)
    if lut_dtype == "float32":
        return lut.contiguous()
    return kops.quantize_luts(lut, lut_dtype)


def split_lut_pack(lut):
    """LUT pack -> (lut, scales | None) for the kernel call sites."""
    if isinstance(lut, tuple):
        qlut, scales = lut
        return qlut.contiguous(), scales.contiguous()
    return lut.contiguous(), None


def coarse_scores(index: IVFPQIndex, QR: torch.Tensor) -> torch.Tensor:
    """⟨q·R, c_l⟩ for every rotated query and list -> (b, L), in products
    of PROBE_ROWS rows (the last one padded with zero rows)."""
    return coarse_product(QR, index.centroids)


def coarse_product(QR: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """QR·centroidsᵀ -> (b, L) in products of PROBE_ROWS rows, so a query's
    coarse scores are the same in any batch (``PROBE_ROWS``)."""
    b = QR.shape[0]
    pad = -b % PROBE_ROWS
    if pad:
        QR = torch.cat([QR, QR.new_zeros((pad, QR.shape[1]))])
    C = centroids.T
    return torch.cat([QR[s:s + PROBE_ROWS] @ C
                      for s in range(0, b + pad, PROBE_ROWS)])[:b]


def probe(index: IVFPQIndex, QR: torch.Tensor,
          nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``nprobe`` lists per rotated query -> ((b, p) int64 lists,
    (b, p) coarse scores). A stable descending sort sends ties to the lower
    list index, as ``lax.top_k`` does."""
    coarse = coarse_scores(index, QR)                             # (b, L)
    vals, lists = torch.sort(coarse, dim=1, descending=True, stable=True)
    return lists[:, :nprobe], vals[:, :nprobe]


def candidate_blocks(index: IVFPQIndex, lists: torch.Tensor,
                     max_blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile schedule of the probed lists -> (block_idx (b, p, B) int32,
    valid (b, p, B) bool). Out-of-range tiles point at the sentinel block."""
    bs = index.block_size
    offsets = index.list_offsets.long()
    lists = lists.long()
    starts = offsets[lists] // bs                                  # (b, p)
    nblocks = (offsets[lists + 1] - offsets[lists]) // bs          # (b, p)
    k = torch.arange(max_blocks, device=lists.device)
    blk = starts[..., None] + k
    valid = k < nblocks[..., None]
    blk = torch.where(valid, blk, torch.full_like(blk, index.sentinel_block))
    return blk.to(torch.int32), valid


class ScanSchedule(NamedTuple):
    """What one batch's probed scan visits, query-major."""

    block_idx: torch.Tensor    # (S,) int32 tile of each step
    block_query: torch.Tensor  # (S,) int32 query of each step
    blocks: torch.Tensor       # (b, p, B) int32, block_idx unflattened
    valid: torch.Tensor        # (b, p, B) bool, False for sentinel tiles
    cscores: torch.Tensor      # (b, p) coarse term of each probed list


def scan_schedule(index: IVFPQIndex, QR: torch.Tensor, *, nprobe: int,
                  max_blocks: int) -> ScanSchedule:
    """Probe and lay out the ``ivf_adc`` schedule: S = b·nprobe·max_blocks
    steps, every query's steps consecutive."""
    b = QR.shape[0]
    lists, cscores = probe(index, QR, nprobe)
    blk, valid = candidate_blocks(index, lists, max_blocks)       # (b, p, B)
    block_query = torch.arange(
        b, dtype=torch.int32, device=QR.device).repeat_interleave(
            nprobe * max_blocks)
    return ScanSchedule(blk.reshape(-1), block_query, blk, valid, cscores)


class ScanScores(NamedTuple):
    """A launched probe scan, before its top-k: the candidates' scores with
    the coarse term added, and the schedule they came from."""

    scores: torch.Tensor       # (b, nprobe·max_blocks·block_size)
    blocks: torch.Tensor       # (b, p, B) int32 tile of each window slot
    valid: torch.Tensor        # (b, p, B) bool, False for sentinel tiles


def scan_scores(index: IVFPQIndex, QR: torch.Tensor, lut, *, nprobe: int,
                max_blocks: int) -> ScanScores:
    """Probe + scan: every candidate's score, no host sync (the launch
    half of a search)."""
    b = QR.shape[0]
    bs = index.block_size
    block_idx, block_query, blk, valid, cscores = scan_schedule(
        index, QR, nprobe=nprobe, max_blocks=max_blocks)
    lut, scales = split_lut_pack(lut)
    # holes/tombstones (id < 0) are −inf inside the kernel; the finite
    # coarse term added afterwards cannot bring them back
    res = kops.ivf_adc(lut, index.codes, block_idx, block_query, scales,
                       index.ids, block_size=bs)
    scores = (res.view(b, nprobe, max_blocks, bs)
              + cscores[:, :, None, None]).reshape(b, -1)
    return ScanScores(scores, blk, valid)


def scan_topk(index: IVFPQIndex, scan: ScanScores, k: int) -> SearchResult:
    """The top-k of a launched scan (one host sync, in ``_candidates``)."""
    scores, blk, valid = scan
    b = scores.shape[0]
    bs = index.block_size
    pos = _candidates(scores, k)
    rows = (blk.view(b, -1).long().gather(1, torch.div(
        pos, bs, rounding_mode="floor")) * bs + pos % bs)
    top_scores, top_ids = kref.topk_merge_ref(
        scores.gather(1, pos), index.ids[rows], k)
    scanned = valid.reshape(b, -1).sum(dim=1).to(torch.int32) * bs
    return SearchResult(scores=top_scores, ids=top_ids, scanned=scanned)


def _search_core(index: IVFPQIndex, QR: torch.Tensor, lut, *, nprobe: int,
                 k: int, max_blocks: int) -> SearchResult:
    """Probe + scan + top-k over rotated queries and a built LUT pack."""
    return scan_topk(index, scan_scores(index, QR, lut, nprobe=nprobe,
                                        max_blocks=max_blocks), k)


def search_fixed(index: IVFPQIndex, Q: torch.Tensor, *, nprobe: int,
                 k: int = 10, max_blocks: int,
                 lut_dtype: str = "float32") -> SearchResult:
    """Search with an explicit probe window ``max_blocks`` (≥
    ``index.max_list_blocks()`` for exactness)."""
    QR = Q @ index.R
    lut = build_luts(index.quantizer, QR, lut_dtype)
    return _search_core(index, QR, lut, nprobe=nprobe, k=k,
                        max_blocks=max_blocks)


def search_prepared(index: IVFPQIndex, QR: torch.Tensor, lut, *,
                    nprobe: int, k: int = 10,
                    max_blocks: int) -> SearchResult:
    """``search_fixed`` with QR = Q·R and the LUT pack supplied."""
    return _search_core(index, QR, lut, nprobe=nprobe, k=k,
                        max_blocks=max_blocks)


def search(index: IVFPQIndex, Q: torch.Tensor, *, nprobe: int, k: int = 10,
           lut_dtype: str = "float32") -> SearchResult:
    """Batched ANN search: (b, n) queries -> top-k (scores, ids, scanned)."""
    nprobe = min(nprobe, index.num_lists)
    return search_fixed(index, Q, nprobe=nprobe, k=k,
                        max_blocks=index.max_list_blocks(),
                        lut_dtype=lut_dtype)


def flat_adc_scores(index: IVFPQIndex, Q: torch.Tensor, *,
                    lut_dtype: str = "float32"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every CSR row (coarse term + residual ADC) -> ((b, cap) scores
    with holes at −inf, (cap,) ids): the exactness oracle of
    nprobe = num_lists."""
    QR = Q @ index.R
    lut = build_luts(index.quantizer, QR, lut_dtype)
    return flat_adc_prepared(index, QR, lut)


def flat_adc_prepared(index: IVFPQIndex, QR: torch.Tensor, lut
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flat_adc_scores`` with QR and the LUT pack supplied."""
    lut, scales = split_lut_pack(lut)
    res = kops.adc_lookup(lut, index.codes, scales, index.ids)    # (b, cap)
    rows = torch.arange(index.capacity, device=QR.device,
                        dtype=index.list_offsets.dtype)
    row_list = torch.searchsorted(index.list_offsets, rows, right=True) - 1
    row_list = torch.clamp(row_list, 0, index.num_lists - 1)
    coarse = coarse_scores(index, QR)                              # (b, L)
    return res + coarse[:, row_list], index.ids
