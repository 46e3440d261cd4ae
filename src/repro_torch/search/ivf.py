"""IVF searcher: probe the top-``nprobe`` lists, scan only their tiles
through the ``ivf_adc`` kernel (port of ``repro/search/ivf.py``).

``nprobe`` is the serving knob and can be overridden per call. Staged rows
of live churn (``state.staging``) merge into every search's top-k.
``refresh``
absorbs a disjoint GivensDelta: eagerly via ``maintain.refresh_delta``
(centroids, codebooks and R rotate; codes and the CSR layout stay), or in
fused mode on the query side only (``search/flat.py``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.churn import buffer as churn_buffer
from repro_torch.index import ivf as index_ivf
from repro_torch.index import search as index_search
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.search import flat
from repro_torch.search.base import SearchConfig, SearchResult
from repro_torch.search.flat import ADCState, _adc_stats, _refresh


@dataclasses.dataclass(frozen=True)
class IVF:
    """Registry backend ``"ivf"``."""

    name: ClassVar[str] = "ivf"

    def build(self, generator: torch.Generator, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *, device=None) -> ADCState:
        index = index_ivf.build(generator, corpus, R, cfg.ivf_config(),
                                train_size=cfg.train_size, device=device)
        return self.attach(index, nprobe=cfg.nprobe, lut_dtype=cfg.lut_dtype,
                           fused_refresh=cfg.fused_refresh)

    @staticmethod
    def attach(index: IVFPQIndex, *, nprobe: int = 8,
               lut_dtype: str = "float32",
               fused_refresh: bool = False) -> ADCState:
        """State over an existing index (captures the probe window)."""
        state = ADCState(index=index, max_blocks=index.max_list_blocks(),
                         nprobe=min(nprobe, index.num_lists),
                         lut_dtype=lut_dtype)
        return flat._fused_state(state) if fused_refresh else state

    def effective_nprobe(self, state: ADCState, nprobe: int | None) -> int:
        """The probe width served: the request's (or the state's default),
        capped at num_lists. The Engine keys its executables on it, so
        oversized requests share one."""
        return min(state.nprobe if nprobe is None else nprobe,
                   state.index.num_lists)

    def search(self, state: ADCState, Q: torch.Tensor, *, k: int = 10,
               nprobe: int | None = None) -> SearchResult:
        """Top-k of a query batch; ``nprobe`` overrides the state's, capped
        at num_lists."""
        QR = flat._rotate_queries(state, Q)
        return self.search_prepared(state, QR, flat._luts(state, QR), k=k,
                                    nprobe=nprobe)

    # -- Engine LUT-cache capabilities -------------------------------------
    def rotate_queries(self, state: ADCState, Q) -> torch.Tensor:
        return flat._rotate_queries(state, Q)

    def luts(self, state: ADCState, QR: torch.Tensor):
        return flat._luts(state, QR)

    def luts_refresh_invariant(self, state: ADCState, delta) -> bool:
        return flat._luts_refresh_invariant(state, delta)

    def search_prepared(self, state: ADCState, QR: torch.Tensor, lut, *,
                        k: int = 10,
                        nprobe: int | None = None) -> SearchResult:
        res = index_search.search_prepared(
            state.index, QR, lut, nprobe=self.effective_nprobe(state, nprobe),
            k=k, max_blocks=state.max_blocks)
        if state.staging is not None:
            # live churn: staged rows ride a flat-ADC side pass over the
            # same LUT pack and merge into the probed top-k
            res = churn_buffer.merge_staged(res, state.staging, QR, lut,
                                            state.index.centroids, k)
        return res

    def refresh(self, state: ADCState, delta) -> ADCState:
        return _refresh(state, delta)

    def stats(self, state: ADCState) -> dict:
        st = _adc_stats(self.name, state)
        st["nprobe"] = state.nprobe
        st["max_blocks"] = state.max_blocks
        st["scan_rows_per_query"] = min(
            state.nprobe * state.max_blocks * state.index.block_size,
            st["capacity"])
        return st
