"""Flat-ADC searcher: scores every CSR row of an IVF-PQ index through the
``adc_lookup`` kernel (port of ``repro/search/flat.py``, eager refresh).

``ADCState`` is shared with the ``ivf`` backend: ``attach`` one index to
both and ``ivf`` at ``nprobe = num_lists`` returns this backend's result.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.index import ivf as index_ivf
from repro_torch.index import maintain
from repro_torch.index import search as index_search
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.search.base import SearchConfig, SearchResult, topk_padded


@dataclasses.dataclass(frozen=True)
class ADCState:
    """Quantized-backend state: the index and its serving knobs.
    ``max_blocks`` is the index's longest list in tiles, read once at
    attach (a refresh keeps the CSR layout)."""

    index: IVFPQIndex
    max_blocks: int
    nprobe: int = 8
    lut_dtype: str = "float32"


def _adc_stats(name: str, state: ADCState) -> dict:
    index = state.index
    code_bytes = int(index.codes.shape[1] * index.codes.element_size())
    return dict(
        backend=name,
        device=str(index.device),
        rows=index.num_items(),
        capacity=index.capacity,
        dim=index.dim,
        num_lists=index.num_lists,
        code_bytes_per_row=code_bytes,
        compression=float(index.dim * 4 / code_bytes),
        memory_bytes=int(index.codes.numel() * index.codes.element_size()),
        lut_dtype=state.lut_dtype,
    )


def _refresh(state: ADCState, delta) -> ADCState:
    return dataclasses.replace(
        state, index=maintain.refresh_delta(state.index, delta))


def _rotate_and_luts(state: ADCState, Q: torch.Tensor):
    """(QR, LUT pack) for a query batch, on the index's device."""
    QR = Q.to(state.index.device) @ state.index.R
    return QR, index_search.build_luts(state.index.quantizer, QR,
                                       state.lut_dtype)


@dataclasses.dataclass(frozen=True)
class FlatADC:
    """Registry backend ``"flat_adc"``."""

    name: ClassVar[str] = "flat_adc"

    def build(self, generator: torch.Generator, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *, device=None) -> ADCState:
        index = index_ivf.build(generator, corpus, R, cfg.ivf_config(),
                                train_size=cfg.train_size, device=device)
        return self.attach(index, lut_dtype=cfg.lut_dtype)

    @staticmethod
    def attach(index: IVFPQIndex, *, lut_dtype: str = "float32") -> ADCState:
        """State over an existing index (flat-scan the codes another
        backend probes)."""
        return ADCState(index=index, max_blocks=index.max_list_blocks(),
                        lut_dtype=lut_dtype)

    def search(self, state: ADCState, Q: torch.Tensor, *,
               k: int = 10) -> SearchResult:
        QR, lut = _rotate_and_luts(state, Q)
        scores, cand_ids = index_search.flat_adc_prepared(state.index, QR,
                                                          lut)
        top_scores, top_ids = topk_padded(scores, cand_ids, k)
        scanned = torch.full((QR.shape[0],), state.index.capacity,
                             dtype=torch.int32, device=QR.device)
        return SearchResult(scores=top_scores, ids=top_ids, scanned=scanned)

    def refresh(self, state: ADCState, delta) -> ADCState:
        return _refresh(state, delta)

    def stats(self, state: ADCState) -> dict:
        st = _adc_stats(self.name, state)
        st["scan_rows_per_query"] = st["capacity"]
        return st
