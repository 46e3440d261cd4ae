"""Flat-ADC searcher: scores every CSR row of an IVF-PQ index through the
``adc_lookup`` kernel (port of ``repro/search/flat.py``).

``ADCState`` is shared with the ``ivf`` backend: ``attach`` one index to
both and ``ivf`` at ``nprobe = num_lists`` returns this backend's result.

Fused refresh (``SearchConfig.fused_refresh``): the index (R, centroids,
codebooks, codes) is frozen at build time and deltas accumulate on the
query side. The state carries ``rot = R₀·Δ`` (the live rotation, for stats
and health), ``wacc`` (W, the within-subspace part of the accumulated
delta) and ``qdelta = Δ·Wᵀ``. Tables are built as the LUT of Q·R₀·qdelta
against the frozen codebooks by the ``fused_lut`` kernel, equal to the
eager LUT of Q·R₀·Δ against the codebooks rotated by W because Wᵀ is
block-diagonal per subspace. A refresh is then three (n, n) products, no
corpus-side buffer moves, and for a purely within-subspace delta (what
``subspace_gcd`` emits) qdelta does not change in exact arithmetic, so the
Engine keeps its whole LUT cache (``luts_refresh_invariant``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch import quant
from repro_torch.churn import buffer as churn_buffer
from repro_torch.index import ivf as index_ivf
from repro_torch.index import maintain
from repro_torch.index import search as index_search
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.kernels import ops as kops
from repro_torch.rotations import GivensDelta
from repro_torch.search.base import (
    SearchConfig,
    SearchResult,
    rotate,
    topk_padded,
)


@dataclasses.dataclass(frozen=True)
class ADCState:
    """Quantized-backend state: the index and its serving knobs.

    ``max_blocks`` is the index's longest list in tiles, read once at
    attach (a refresh keeps the CSR layout; ``churn.with_staging`` widens
    it by the buffer's slack). ``rot``/``wacc``/``qdelta`` are the
    fused-refresh matrices (module docstring) and ``lut_cols`` the
    fused_lut kernel's column map, made once at attach; all four are None
    in eager mode. ``staging`` is the live-churn append buffer
    (``repro_torch.churn``): None until ``churn.with_staging`` installs
    one; its rows are scanned by a flat-ADC side pass and merged into every
    search of both backends."""

    index: IVFPQIndex
    max_blocks: int
    nprobe: int = 8
    lut_dtype: str = "float32"
    rot: torch.Tensor | None = None       # (n, n) live rotation R₀·Δ
    wacc: torch.Tensor | None = None      # (n, n) within-subspace product W
    qdelta: torch.Tensor | None = None    # (n, n) query-side transform Δ·Wᵀ
    lut_cols: torch.Tensor | None = None  # (Dp,) int32 column -> subspace
    staging: churn_buffer.StagingBuffer | None = None


def _fused_state(state: ADCState) -> ADCState:
    """Start the fused-refresh matrices at the build rotation
    (Δ = W = I: rot = R₀, qdelta = I)."""
    R = state.index.R
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    _, colmap = state.index.quantizer.lut_operands()
    return dataclasses.replace(state, rot=R, wacc=eye, qdelta=eye,
                               lut_cols=kops.lut_column_map(colmap))


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
        fused_refresh=state.rot is not None,
    )


def _fused_refresh_mats(R0, rot, wacc, pi, pj, theta, sub: int):
    """Advance the fused matrices by one disjoint GivensDelta: the whole
    delta composes into rot, its within-subspace part into wacc, and
    qdelta = R₀ᵀ·rot·waccᵀ (= Δ·Wᵀ) is recomputed: it cannot be updated
    from itself, because the new within part must commute past the
    accumulated cross part."""
    rot = kops.apply_pair_rotations(rot, pi, pj, theta)
    within = torch.div(pi, sub, rounding_mode="floor") == torch.div(
        pj, sub, rounding_mode="floor")
    theta_w = torch.where(within, theta, torch.zeros_like(theta))
    wacc = kops.apply_pair_rotations(wacc, pi, pj, theta_w)
    qdelta = R0.T @ rot @ wacc.T
    return rot, wacc, qdelta


def _refresh(state: ADCState, delta) -> ADCState:
    if state.rot is None:
        return dataclasses.replace(
            state, index=maintain.refresh_delta(state.index, delta))
    # fused: the index stays as built, only the query-side matrices move
    maintain.check_refreshable(delta)
    rot, wacc, qdelta = _fused_refresh_mats(
        state.index.R, state.rot, state.wacc, delta.pi, delta.pj,
        delta.theta, state.index.quantizer.sub)
    return dataclasses.replace(state, rot=rot, wacc=wacc, qdelta=qdelta)


def _rotate_queries(state: ADCState, Q) -> torch.Tensor:
    """Q·R on the index's device. In fused mode R stays R₀, and the coarse
    term is exactly invariant (⟨q·R₀Δ, c·Δ⟩ = ⟨q·R₀, c⟩), so R₀ is the
    right query rotation in both modes, and a stable key for the cache."""
    return rotate(Q, state.index.R)


def _luts(state: ADCState, QR: torch.Tensor):
    """The LUT pack of rotated queries: a (b, Dp, K) float32 tensor, or a
    (qlut, scales) pack for an int8/uint8 ``lut_dtype``. In fused mode the
    accumulated query-side transform goes into the fused_lut kernel."""
    if state.qdelta is None:
        return index_search.build_luts(state.index.quantizer, QR,
                                       state.lut_dtype)
    cb_flat, colmap = state.index.quantizer.lut_operands()
    lut = kops.fused_lut(QR.contiguous(), state.qdelta.contiguous(),
                         cb_flat.contiguous(), colmap, cols=state.lut_cols)
    if state.lut_dtype != "float32":
        return kops.quantize_luts(lut, state.lut_dtype)
    return lut


def _luts_refresh_invariant(state: ADCState, delta) -> bool:
    """True iff cached LUT packs stay exactly valid across
    ``refresh(state, delta)``: fused mode and a purely within-subspace
    GivensDelta (then qdelta' = qdelta; module docstring). Host-side and
    conservative: any doubt returns False."""
    if state.rot is None or not isinstance(delta, GivensDelta):
        return False
    sub = state.index.quantizer.sub
    pi = delta.pi.cpu().numpy()
    pj = delta.pj.cpu().numpy()
    return bool(((pi // sub) == (pj // sub)).all())


def _flat_topk(state: ADCState, QR: torch.Tensor, lut,
               k: int) -> SearchResult:
    scores, cand_ids = index_search.flat_adc_prepared(state.index, QR, lut)
    top_scores, top_ids = topk_padded(scores, cand_ids, k)
    scanned = torch.full((QR.shape[0],), state.index.capacity,
                         dtype=torch.int32, device=QR.device)
    res = SearchResult(scores=top_scores, ids=top_ids, scanned=scanned)
    if state.staging is not None:
        res = churn_buffer.merge_staged(res, state.staging, QR, lut,
                                        state.index.centroids, k)
    return res


@dataclasses.dataclass(frozen=True)
class FlatADC:
    """Registry backend ``"flat_adc"``."""

    name: ClassVar[str] = "flat_adc"

    def build(self, generator: torch.Generator, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *, device=None) -> ADCState:
        index = index_ivf.build(generator, corpus, R, cfg.ivf_config(),
                                train_size=cfg.train_size, device=device)
        return self.attach(index, lut_dtype=cfg.lut_dtype,
                           fused_refresh=cfg.fused_refresh)

    @staticmethod
    def attach(index: IVFPQIndex, *, lut_dtype: str = "float32",
               fused_refresh: bool = False) -> ADCState:
        """State over an existing index (flat-scan the codes another
        backend probes)."""
        state = ADCState(index=index, max_blocks=index.max_list_blocks(),
                         lut_dtype=lut_dtype)
        return _fused_state(state) if fused_refresh else state

    @staticmethod
    def from_quantizer(R: torch.Tensor, quantizer: quant.PQ,
                       corpus: torch.Tensor, *,
                       block_size: int = 128) -> ADCState:
        """Serve a quantizer fitted elsewhere (the PQ that OPQ learned with
        R) without refitting: the corpus is encoded as
        ``quantizer.encode(corpus @ R)`` under one zero-centroid coarse
        list, so the served codes are the quantizer's own."""
        XR = corpus.to(R.device) @ R.to(corpus.dtype)
        coarse = quant.VQ(torch.zeros((1, XR.shape[1]), dtype=XR.dtype,
                                      device=XR.device))
        list_ids, codes = index_ivf.encode(XR, coarse, quantizer)
        ids = torch.arange(XR.shape[0], dtype=torch.int32)
        index = index_ivf.pack(R, coarse, quantizer, codes, list_ids, ids,
                               block_size=block_size)
        return FlatADC.attach(index)

    def search(self, state: ADCState, Q: torch.Tensor, *,
               k: int = 10) -> SearchResult:
        QR = _rotate_queries(state, Q)
        return _flat_topk(state, QR, _luts(state, QR), k)

    # -- Engine LUT-cache capabilities -------------------------------------
    def rotate_queries(self, state: ADCState, Q) -> torch.Tensor:
        return _rotate_queries(state, Q)

    def luts(self, state: ADCState, QR: torch.Tensor):
        return _luts(state, QR)

    def luts_refresh_invariant(self, state: ADCState, delta) -> bool:
        return _luts_refresh_invariant(state, delta)

    def search_prepared(self, state: ADCState, QR: torch.Tensor, lut, *,
                        k: int = 10) -> SearchResult:
        return _flat_topk(state, QR, lut, k)

    def refresh(self, state: ADCState, delta) -> ADCState:
        return _refresh(state, delta)

    def stats(self, state: ADCState) -> dict:
        st = _adc_stats(self.name, state)
        st["scan_rows_per_query"] = st["capacity"]
        return st
