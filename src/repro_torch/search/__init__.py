"""Retrieval backends and the serving Engine (port of ``repro/search``).

    searcher = search.make("ivf")      # or "flat_adc", "exact", "exact_stream"
    state = searcher.build(generator, corpus, R, search.SearchConfig(
        num_lists=1024, subspaces=32, codewords=256, nprobe=32,
        fused_refresh=True))
    res = searcher.search(state, Q, k=10)
    engine = search.Engine(searcher, state, k=10)    # ragged serving
    res = engine.search(Q_any_size)
    engine.refresh(delta)                            # after a GCD step

The row-sharded twins (``exact_sharded``, ``flat_sharded``,
``ivf_sharded``) take a ``launch.mesh.DataMesh``::

    mesh = launch.mesh.make_data_mesh(4, devices=("cuda:0",) * 4)
    searcher = search.make("ivf_sharded", mesh=mesh)
    state = searcher.attach(index, mesh=mesh, nprobe=32)
    # or search.attach_shards(index.ivf.build_sharded(...), mesh=mesh)

``names()`` lists the canonical backends; aliases resolve through ``make``
and ``canonical`` without counting twice.
"""
from repro_torch.search import (  # noqa: F401
    base,
    engine,
    exact,
    flat,
    ivf,
    sharded,
)
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
from repro_torch.search.sharded import (  # noqa: F401
    ExactSharded,
    FlatSharded,
    IVFSharded,
    ShardedADCState,
    ShardedExactState,
    attach_shards,
)

_REGISTRY = {
    "exact": Exact,
    "exact_stream": ExactStreaming,
    "flat_adc": FlatADC,
    "ivf": IVF,
    "exact_sharded": ExactSharded,
    "flat_sharded": FlatSharded,
    "ivf_sharded": IVFSharded,
}

_ALIASES = {
    "flat": "flat_adc",
    "brute_force": "exact",
    "bruteforce": "exact",
    "exact_streaming": "exact_stream",
    "streaming": "exact_stream",
    "flat_adc_sharded": "flat_sharded",
    "sharded": "ivf_sharded",
}


def names() -> tuple[str, ...]:
    """The canonical backends (aliases excluded)."""
    return tuple(_REGISTRY)


def canonical(spec: str) -> str:
    return _ALIASES.get(spec, spec)


def make(spec: str, **kwargs):
    """A backend by registry name or alias; ``kwargs`` go to its
    constructor (the sharded twins take ``mesh`` and ``axis``)."""
    cls = _REGISTRY.get(canonical(spec))
    if cls is None:
        raise ValueError(f"unknown search backend {spec!r}; registered: "
                         f"{names()}")
    return cls(**kwargs)
