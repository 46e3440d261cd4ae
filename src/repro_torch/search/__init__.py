"""Retrieval backends (port of ``repro/search``): ``ivf`` and ``flat_adc``.

    searcher = search.make("ivf")
    state = searcher.build(generator, corpus, R, search.SearchConfig(
        num_lists=1024, subspaces=32, codewords=256, nprobe=32))
    res = searcher.search(state, Q, k=10)

``exact``, the sharded twins and the batching ``Engine`` wait for a later
slice (ROADMAP.md queue 1).
"""
from repro_torch.search import base, flat, ivf  # noqa: F401
from repro_torch.search.base import (  # noqa: F401
    SearchConfig,
    SearchResult,
    topk_padded,
)
from repro_torch.search.flat import ADCState, FlatADC  # noqa: F401
from repro_torch.search.ivf import IVF  # noqa: F401

_REGISTRY = {"ivf": IVF, "flat_adc": FlatADC}


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def make(name: str):
    """A backend by registry name ("ivf" | "flat_adc")."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown search backend {name!r}; ported: "
                         f"{names()} (exact, sharded and Engine: ROADMAP.md "
                         "queue 1)")
    return cls()
