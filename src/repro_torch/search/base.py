"""Search configuration and result (port of ``repro/search/base.py``).

Backends serve through one protocol::

    searcher = search.make("ivf")
    state    = searcher.build(generator, corpus, R, cfg, device="cuda")
    result   = searcher.search(state, Q, k=10)
    state    = searcher.refresh(state, delta)
    facts    = searcher.stats(state)

There is no ``use_kernel`` knob: the state's device decides (the card runs
the CUDA scans, the CPU their plain versions). ``fused_refresh`` and the
``exact`` backend wait for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch import quant
from repro_torch.index.ivf import IVFPQConfig
from repro_torch.index.search import (  # noqa: F401
    NEG_INF,
    SearchResult,
    topk_padded,
)


class SearchConfig(NamedTuple):
    """Build parameters shared by the quantized backends."""

    subspaces: int = 8
    codewords: int = 256
    depth: int = 1
    num_lists: int = 1
    nprobe: int = 8
    block_size: int = 128
    train_size: int | None = None
    lut_dtype: str = "float32"

    def ivf_config(self) -> IVFPQConfig:
        return IVFPQConfig(num_lists=self.num_lists,
                           pq=quant.PQConfig(self.subspaces, self.codewords),
                           block_size=self.block_size, depth=self.depth,
                           lut_dtype=self.lut_dtype)
