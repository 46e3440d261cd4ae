"""Exact brute-force searchers: a tiled scan of the rotated corpus with a
running top-k (port of ``repro/search/exact.py``), the recall oracle.

The corpus is stored rotated (XR = X·R), so search computes (Q·R)·(XR)ᵀ,
equal to Q·Xᵀ because R is orthogonal: the same transform the quantized
backends serve.

Two backends share one merge (``_merge_tile``):

``exact`` keeps the padded corpus on the device and scans (tile_rows, n)
tiles, one (b, n)×(n, tile_rows) ``torch.matmul`` each (an XLA product in
the JAX package, not a Pallas kernel), folding each into a (b, k) running
top-k, so peak memory is O(b·(k + tile_rows)), not the O(b·N) of the whole
score matrix.

``exact_stream`` keeps the corpus tiles in pinned host memory and copies
them to the card with ``non_blocking=True`` on a side CUDA stream into two
device buffers: tile t+1's copy runs while tile t is scored, ordered by
events (a copy waits until its buffer's previous scan is done, a scan until
its copy is). On the CPU it is the same loop without streams. The host loop
is the search, so ``engine_jit = False`` sends the Engine down its plain,
uncached path.

The merge keeps the top-k contract of ``kernels.ref.topk_merge_ref``: equal
scores go to the smaller id. The running carry comes first in the merge and
ids grow with the row, so one stable sort by descending score gives that
order (as the JAX merge's ``lax.top_k`` does). Padding rows (id −1) score
−inf.

``refresh``: eagerly it right-multiplies R and the stored corpus by the
delta (scores are invariant: rotations keep inner products). Under
``SearchConfig.fused_refresh`` the corpus stays at the build rotation R₀
and queries are rotated by R₀, exact because ⟨q·R₀Δ, x·R₀Δ⟩ = ⟨q·R₀, x·R₀⟩:
a refresh moves only R, which tracks the trainer for stats and health.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch import device as _device
from repro_torch import rotations
from repro_torch.search.base import (
    NEG_INF,
    SearchConfig,
    SearchResult,
    rotate,
)


@dataclasses.dataclass(frozen=True)
class ExactState:
    """Rotated corpus padded to whole tiles (padding rows carry id −1).
    ``R0`` is the frozen build rotation of fused mode (None = eager): XR
    then stays X·R₀ and queries are rotated by R₀, while R tracks the
    trained rotation."""

    R: torch.Tensor          # (n, n) serving rotation
    XR: torch.Tensor         # (T·tile_rows, n) rotated corpus, zero-padded
    ids: torch.Tensor        # (T·tile_rows,) int32 item ids, −1 = padding
    tile_rows: int = 4096
    R0: torch.Tensor | None = None


def _merge_tile(carry, s: torch.Tensor, ids: torch.Tensor, k: int):
    """Fold one (b, t) score tile with row ids (t,) into the (b, k) running
    (scores, ids) carry. Every id of the tile is larger than every id in
    the carry, so a stable descending sort ranks equal scores by id."""
    best_s, best_i = carry
    s = s.masked_fill(ids[None, :] < 0, NEG_INF)
    cat_s = torch.cat([best_s, s], dim=1)
    cat_i = torch.cat([best_i, ids[None, :].expand(s.shape[0], -1)], dim=1)
    top_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    top_i = cat_i.gather(1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i,
                        torch.full_like(top_i, -1))
    return top_s, top_i


def _init_carry(b: int, k: int, dev: torch.device):
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))


def _query_rotation(state) -> torch.Tensor:
    """R₀ when the state is fused-frozen, else the live R."""
    return state.R if state.R0 is None else state.R0


def _tile_ids(start: int, rows: int, tile: int) -> torch.Tensor:
    ids = torch.full((tile,), -1, dtype=torch.int32)
    ids[:rows] = torch.arange(start, start + rows, dtype=torch.int32)
    return ids


@dataclasses.dataclass(frozen=True)
class Exact:
    """Registry backend ``"exact"`` (see the module docstring)."""

    name: ClassVar[str] = "exact"

    def build(self, generator: torch.Generator | None, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *,
              device=None) -> ExactState:
        """The build is deterministic; ``generator`` is not used."""
        dev = _device.resolve(device)
        R = R.to(dev, torch.float32)
        XR = corpus.to(dev, torch.float32) @ R
        rows = XR.shape[0]
        tile = max(1, min(cfg.tile_rows, rows))
        pad = (-rows) % tile
        XR = torch.cat([XR, XR.new_zeros((pad, XR.shape[1]))])
        ids = _tile_ids(0, rows, rows + pad).to(dev)
        return ExactState(R=R, XR=XR, ids=ids, tile_rows=tile,
                          R0=R if cfg.fused_refresh else None)

    def search(self, state: ExactState, Q, *, k: int = 10) -> SearchResult:
        QR = rotate(Q, _query_rotation(state))
        b, n = QR.shape
        tiles = state.XR.view(-1, state.tile_rows, n)
        tile_ids = state.ids.view(-1, state.tile_rows)
        carry = _init_carry(b, k, QR.device)
        for xr, ids in zip(tiles, tile_ids):
            carry = _merge_tile(carry, QR @ xr.T, ids, k)
        scanned = torch.full((b,), int(torch.sum(state.ids >= 0)),
                             dtype=torch.int32, device=QR.device)
        return SearchResult(scores=carry[0], ids=carry[1], scanned=scanned)

    def refresh(self, state: ExactState, delta) -> ExactState:
        R = rotations.apply(state.R, delta)
        if state.R0 is not None:
            # fused: the frozen corpus cancels the delta; XR stays
            return dataclasses.replace(state, R=R)
        return dataclasses.replace(state, R=R,
                                   XR=rotations.apply(state.XR, delta))

    def stats(self, state: ExactState) -> dict:
        rows = int(torch.sum(state.ids >= 0))
        return dict(
            backend=self.name,
            device=str(state.XR.device),
            rows=rows,
            capacity=int(state.ids.shape[0]),
            dim=int(state.XR.shape[1]),
            tile_rows=state.tile_rows,
            scan_rows_per_query=rows,
            memory_bytes=int(state.XR.numel() * state.XR.element_size()),
            compression=1.0,
            fused_refresh=state.R0 is not None,
        )


@dataclasses.dataclass(frozen=True)
class StreamingExactState:
    """Corpus tiles in host memory (pinned when the serving device is the
    card), streamed through the device by every search."""

    R: torch.Tensor          # (n, n) serving rotation, on the device
    tiles: tuple             # T × (tile_rows, n) float32 host tensors
    tile_ids: tuple          # T × (tile_rows,) int32 host tensors, −1 = pad
    tile_rows: int
    rows: int                # live rows
    R0: torch.Tensor | None = None


def _to_host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    host = t.to("cpu")
    return host.pin_memory() if pin else host


@dataclasses.dataclass(frozen=True)
class ExactStreaming:
    """Registry backend ``"exact_stream"``: the oracle past device memory.
    Same scores as ``exact``, with the corpus in host memory and tiles
    double-buffered through the device (module docstring)."""

    name: ClassVar[str] = "exact_stream"
    engine_jit: ClassVar[bool] = False

    def build(self, generator: torch.Generator | None, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *,
              device=None) -> StreamingExactState:
        """Rotates the corpus tile by tile on ``device`` (the whole corpus
        is never on it at once); deterministic, ``generator`` is not
        used."""
        dev = _device.resolve(device)
        R = R.to(dev, torch.float32)
        rows, n = corpus.shape
        tile = max(1, min(cfg.tile_rows, rows))
        pin = dev.type == "cuda"
        tiles, tile_ids = [], []
        for start in range(0, rows, tile):
            chunk = corpus[start:start + tile].to(dev, torch.float32)
            xr = chunk @ R
            m = xr.shape[0]
            if m < tile:
                xr = torch.cat([xr, xr.new_zeros((tile - m, n))])
            tiles.append(_to_host(xr, pin))
            tile_ids.append(_to_host(_tile_ids(start, m, tile), pin))
        return StreamingExactState(
            R=R, tiles=tuple(tiles), tile_ids=tuple(tile_ids),
            tile_rows=tile, rows=rows, R0=R if cfg.fused_refresh else None)

    def search(self, state: StreamingExactState, Q, *,
               k: int = 10) -> SearchResult:
        QR = rotate(Q, _query_rotation(state))
        dev = QR.device
        carry = _init_carry(QR.shape[0], k, dev)
        if dev.type == "cuda":
            carry = self._scan_streamed(state, QR, carry, k)
        else:
            for xr, ids in zip(state.tiles, state.tile_ids):
                carry = _merge_tile(carry, QR @ xr.T, ids, k)
        scanned = torch.full((QR.shape[0],), state.rows, dtype=torch.int32,
                             device=dev)
        return SearchResult(scores=carry[0], ids=carry[1], scanned=scanned)

    @staticmethod
    def _scan_streamed(state, QR, carry, k: int):
        """The double-buffered scan on the card: copies on a side stream,
        scans on the current one."""
        dev = QR.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        shape = state.tiles[0].shape
        bufs = [(torch.empty(shape, dtype=torch.float32, device=dev),
                 torch.empty((shape[0],), dtype=torch.int32, device=dev))
                for _ in range(2)]
        copied = [torch.cuda.Event() for _ in range(2)]
        scanned = [torch.cuda.Event() for _ in range(2)]

        def copy(t: int) -> None:
            slot = t % 2
            with torch.cuda.stream(side):
                if t >= 2:    # the buffer's previous tile must be scanned
                    side.wait_event(scanned[slot])
                bufs[slot][0].copy_(state.tiles[t], non_blocking=True)
                bufs[slot][1].copy_(state.tile_ids[t], non_blocking=True)
                copied[slot].record(side)

        T = len(state.tiles)
        copy(0)
        for t in range(T):
            if t + 1 < T:
                copy(t + 1)
            slot = t % 2
            main.wait_event(copied[slot])
            xr, ids = bufs[slot]
            carry = _merge_tile(carry, QR @ xr.T, ids, k)
            scanned[slot].record(main)
        return carry

    def refresh(self, state: StreamingExactState,
                delta) -> StreamingExactState:
        R = rotations.apply(state.R, delta)
        if state.R0 is not None:
            # fused: the frozen host tiles cancel the delta; nothing moves
            return dataclasses.replace(state, R=R)
        # eager: every tile goes through the device and back
        dev = R.device
        pin = dev.type == "cuda"
        tiles = tuple(_to_host(rotations.apply(t.to(dev), delta), pin)
                      for t in state.tiles)
        return dataclasses.replace(state, R=R, tiles=tiles)

    def stats(self, state: StreamingExactState) -> dict:
        n = state.tiles[0].shape[1] if state.tiles else 0
        return dict(
            backend=self.name,
            device=str(state.R.device),
            rows=state.rows,
            capacity=state.tile_rows * len(state.tiles),
            dim=n,
            tile_rows=state.tile_rows,
            scan_rows_per_query=state.rows,
            memory_bytes=sum(t.numel() * 4 for t in state.tiles),
            device_bytes=2 * state.tile_rows * n * 4,   # two tile buffers
            compression=1.0,
            streaming=True,
            fused_refresh=state.R0 is not None,
        )
