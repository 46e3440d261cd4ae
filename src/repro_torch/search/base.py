"""Searcher protocol, search configuration and result (port of
``repro/search/base.py``).

Every backend serves through one protocol::

    searcher = search.make("ivf")
    state    = searcher.build(generator, corpus, R, cfg, device="cuda")
    result   = searcher.search(state, Q, k=10)
    state    = searcher.refresh(state, delta)
    facts    = searcher.stats(state)

``refresh`` takes the ``rotations.GivensDelta`` a learner's ``update``
returns, so a trainer and a live index fed the same delta serve the same
rotation. Every backend returns a ``SearchResult`` under one padding
contract: past the candidate pool, ids are −1 and scores −inf.

There is no ``use_kernel`` knob: the state's device decides (the card runs
the CUDA kernels, the CPU their plain versions). ``fused_refresh`` makes
the quantized and exact backends absorb deltas on the query side only:
corpus buffers stay as built and a refresh moves (n, n) matrices.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import quant
from repro_torch.index.ivf import IVFPQConfig
from repro_torch.index.search import (  # noqa: F401
    NEG_INF,
    SearchResult,
    topk_padded,
)


def as_tensor(Q) -> torch.Tensor:
    """A query batch given as a tensor (kept as it is) or an array (copied
    into a CPU tensor)."""
    return Q if isinstance(Q, torch.Tensor) else torch.tensor(np.asarray(Q))


def rotate(Q, R: torch.Tensor) -> torch.Tensor:
    """Q·R on R's device and in R's dtype."""
    return as_tensor(Q).to(device=R.device, dtype=R.dtype) @ R


class SearchConfig(NamedTuple):
    """Build parameters shared by the backends; each reads its part.

    The quantized backends (``flat_adc``, ``ivf``) read the IVF-PQ fields
    and ``lut_dtype`` ("float32" | "int8" | "uint8"); ``exact`` reads only
    ``tile_rows``, the corpus tile of its scan. ``fused_refresh`` freezes
    the corpus side at build time and accumulates deltas on the query side
    (``search/flat.py``, ``search/exact.py``)."""

    subspaces: int = 8
    codewords: int = 256
    depth: int = 1
    num_lists: int = 1
    nprobe: int = 8
    block_size: int = 128
    tile_rows: int = 4096
    train_size: int | None = None
    lut_dtype: str = "float32"
    fused_refresh: bool = False

    def ivf_config(self) -> IVFPQConfig:
        return IVFPQConfig(num_lists=self.num_lists,
                           pq=quant.PQConfig(self.subspaces, self.codewords),
                           block_size=self.block_size, depth=self.depth,
                           lut_dtype=self.lut_dtype)


@runtime_checkable
class Searcher(Protocol):
    """The retrieval-backend protocol (see the module docstring).

    Backends are frozen dataclasses that hold no per-corpus data; it all
    lives in the state. The Engine looks for optional capabilities:
    ``rotate_queries``/``luts``/``search_prepared`` (the per-query LUT
    cache), ``luts_refresh_invariant`` and ``effective_nprobe``, and
    ``engine_jit = False`` for a host-loop backend. (The JAX package's
    ``prepare_state`` has nothing to do here: ``attach`` reads
    ``max_blocks`` already.)
    """

    def build(self, generator: torch.Generator, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *, device=None) -> Any:
        """Offline: index ``corpus`` under the learned rotation ``R``."""
        ...

    def search(self, state: Any, Q: torch.Tensor, *,
               k: int = 10) -> SearchResult:
        """Top-``k`` by inner product for a (b, n) query batch."""
        ...

    def refresh(self, state: Any, delta) -> Any:
        """Absorb a rotation learner's step into the servable state."""
        ...

    def stats(self, state: Any) -> dict:
        """Host-side serving facts (rows, scan work, memory, knobs)."""
        ...
