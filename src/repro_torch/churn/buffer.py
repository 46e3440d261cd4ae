"""Append buffers: the staging lane of live churn (port of
``repro/churn/buffer.py``).

A live index cannot repack its CSR per insert (``ivf.pack`` is a host-side
relayout of the whole codes array). New rows land in a fixed-capacity
``StagingBuffer`` instead: rotated and residual-encoded already, so they
score through the same LUTs as the CSR, tagged with their coarse list, and
scanned by a flat-ADC side pass (the ``adc_lookup`` kernel) whose padded
top-k merges into the main scan's result by ``kernels.ops.topk_merge``.
``churn.ops.flush`` later folds staged rows into CSR holes; until then they
are served from here, so an add is visible to the very next query.

The buffer keeps its shapes: a free slot carries id −1 and scores −inf
through the scan's id mask, so staging, serving and flushing never change a
tensor's shape under the Engine's executables. Every operation builds new
tensors; nothing here writes into a buffer another state can still reach.

No ``repro_torch.search`` imports: the searchers import this module.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.index import search as index_search
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class StagingBuffer:
    """Fixed-capacity append buffer. A slot is free iff its id is −1;
    ``lists`` holds each staged row's coarse list, so the side pass adds
    the same coarse term ⟨q·R, c_l⟩ the main scan adds per block."""

    codes: torch.Tensor  # (cap, Dp) residual codes, the CSR's dtype
    ids: torch.Tensor    # (cap,) int32 item ids, −1 = free
    lists: torch.Tensor  # (cap,) int32 target coarse list

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]


def empty(capacity: int, code_width: int, code_dtype: torch.dtype, *,
          device=None) -> StagingBuffer:
    """An all-free buffer matching an index's code layout, on ``device``
    (the caller's index's; the churn ops pass it)."""
    return StagingBuffer(
        codes=torch.zeros((capacity, code_width), dtype=code_dtype,
                          device=device),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        lists=torch.zeros((capacity,), dtype=torch.int32, device=device))


def staged_topk(buf: StagingBuffer, QR: torch.Tensor, lut,
                centroids: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat-ADC side pass: every staged row scored under the same LUT
    pack the main scan reads, with ``buf.ids`` as the mask (free slots
    −inf), plus the coarse term of its list, then a padded (b, k) top-k.
    The coarse product runs in the main scan's fixed-shape chunks
    (``index.search.coarse_product``), so a staged row scores bit for bit
    as it will once flushed into the CSR."""
    lut, scales = index_search.split_lut_pack(lut)
    res = kops.adc_lookup(lut, buf.codes, scales, buf.ids)      # (b, cap)
    coarse = index_search.coarse_product(QR, centroids)         # (b, L)
    scores = res + coarse[:, buf.lists.long()]
    return index_search.topk_padded(scores, buf.ids, k)


def merge_staged(res: index_search.SearchResult, buf: StagingBuffer,
                 QR: torch.Tensor, lut, centroids: torch.Tensor,
                 k: int) -> index_search.SearchResult:
    """Fold the side pass into a main-scan result: the two padded top-k
    runs concatenated and re-ranked by ``topk_merge`` ((−score, id) order,
    −inf slots re-padded to id −1). ``scanned`` grows by the live staged
    rows, counted on the device."""
    s, i = staged_topk(buf, QR, lut, centroids, k)
    scores, ids = kops.topk_merge(torch.cat([res.scores, s], dim=1),
                                  torch.cat([res.ids, i], dim=1), k)
    scanned = res.scanned + torch.sum(buf.ids >= 0).to(res.scanned.dtype)
    return index_search.SearchResult(scores=scores, ids=ids, scanned=scanned)
