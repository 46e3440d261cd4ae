"""Retrieval backends and the serving Engine (port of ``repro/search``).

    searcher = search.make("ivf")      # or "flat_adc", "exact", "exact_stream"
    state = searcher.build(generator, corpus, R, search.SearchConfig(
        num_lists=1024, subspaces=32, codewords=256, nprobe=32,
        fused_refresh=True))
    res = searcher.search(state, Q, k=10)
    engine = search.Engine(searcher, state, k=10)    # ragged serving
    res = engine.search(Q_any_size)
    engine.refresh(delta)                            # after a GCD step

``names()`` lists the canonical backends; aliases resolve through ``make``
and ``canonical`` without counting twice. The row-sharded twins
(``exact_sharded``, ``flat_sharded``, ``ivf_sharded``) wait for a later
slice (ROADMAP.md queue 11).
"""
from repro_torch.search import base, engine, exact, flat, ivf  # noqa: F401
from repro_torch.search.base import (  # noqa: F401
    SearchConfig,
    Searcher,
    SearchResult,
    topk_padded,
)
from repro_torch.search.engine import Engine, Pending  # noqa: F401
from repro_torch.search.exact import (  # noqa: F401
    Exact,
    ExactState,
    ExactStreaming,
    StreamingExactState,
)
from repro_torch.search.flat import ADCState, FlatADC  # noqa: F401
from repro_torch.search.ivf import IVF  # noqa: F401

_REGISTRY = {
    "exact": Exact,
    "exact_stream": ExactStreaming,
    "flat_adc": FlatADC,
    "ivf": IVF,
}

_ALIASES = {
    "flat": "flat_adc",
    "brute_force": "exact",
    "bruteforce": "exact",
    "exact_streaming": "exact_stream",
    "streaming": "exact_stream",
}

_SHARDED = ("exact_sharded", "flat_sharded", "ivf_sharded",
            "flat_adc_sharded", "sharded")


def names() -> tuple[str, ...]:
    """The canonical backends (aliases excluded)."""
    return tuple(_REGISTRY)


def canonical(spec: str) -> str:
    return _ALIASES.get(spec, spec)


def make(spec: str, **kwargs):
    """A backend by registry name or alias; ``kwargs`` go to its
    constructor (the backends take none yet)."""
    if spec in _SHARDED:
        raise NotImplementedError(
            f"search backend {spec!r}: the sharded twins are not ported yet "
            "(ROADMAP.md queue 11)")
    cls = _REGISTRY.get(canonical(spec))
    if cls is None:
        raise ValueError(f"unknown search backend {spec!r}; registered: "
                         f"{names()}")
    return cls(**kwargs)
