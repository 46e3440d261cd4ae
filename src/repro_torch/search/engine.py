"""search.Engine: the batching serving front end (port of
``repro/search/engine.py``).

Query traffic is ragged: requests arrive at any batch size. The Engine sits
between callers and a Searcher:

  * **bucketing**: a (b, n) batch is zero-padded up to the next power of
    two (≥ ``min_bucket``), so the set of served shapes is logarithmic in
    the largest batch; results are sliced back to b rows. Batches beyond
    ``max_bucket`` are chunked.
  * **executables**: one callable per ``("plain" | "prepared", bucket, k,
    nprobe)`` key, made on first use and kept. A ``refresh`` swaps the
    state under them.
  * **per-query LUT cache**: for the quantized backends the (Dp, K) table
    is the per-query set-up cost; repeated queries reuse their cached pack
    (keyed by the raw query bytes, ``lut_dtype`` and the invalidation
    epoch, LRU-evicted) and only misses pay the build. A refresh clears
    the cache unless the backend proves the tables exactly invariant
    across the delta (``luts_refresh_invariant``: fused refresh and a
    within-subspace delta); ``stats()["lut_invalidations"]`` counts the
    clears. Backends without ``search_prepared`` (``exact``) take the plain
    path; a host-loop backend (``exact_stream``, ``engine_jit = False``)
    takes it without counting a compile.
  * **submit/collect**: ``submit`` launches a batch and returns a
    ``Pending`` without waiting for the card; ``collect`` waits for it and
    records the request. ``search`` is ``collect(submit(...))`` with
    chunking.
  * **observability**: every request lands in a private, always-on
    ``obs.Registry`` (latency p50/p95/p99, scanned rows, pad waste, LUT
    hit rate, compiles) that ``stats()`` reads; an attached
    ``obs.RecallProbe`` replays its pinned queries through the serving
    path every N requests. With the global registry enabled, ``refresh``
    also records the delta norm and the orthogonality drift
    (``index.maintain.refresh_health``).

Two mechanisms of the JAX Engine have no counterpart in PyTorch:

  * **Compiles.** PyTorch runs eagerly and nothing is traced. Here an
    "executable" is the per-key callable, and ``compiles`` counts its first
    uses. The JAX Engine traces once per key, so both Engines count the
    same for the same request sequence (a JAX retrace under one key, after
    a state of another ``lut_dtype`` is swapped in, has no counterpart).
  * **Donation.** Dropped: PyTorch's caching allocator reuses the padded
    query and LUT buffers.

Submit is not fully asynchronous on the card. ``submit`` records a CUDA
event after the batch's launches and ``collect`` waits on that event, then
reads the host clock; but the IVF search synchronises with the host once
per batch, in ``index/search.py`` ``_candidates`` (``int(keep.sum(dim=1)
.max())``: the width of the candidate set), and the LUT cache copies each
batch's missed tables to the host. The same sync keeps a batch from being
captured as a CUDA graph.

Typical loop::

    engine = search.Engine(search.make("ivf"), state, k=10, nprobe=32)
    for batch in requests:
        res = engine.search(batch)          # any batch size
    engine.refresh(delta)                    # after a GCD training step
    print(engine.stats())
"""
from __future__ import annotations

import collections
import inspect
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.search.base import SearchResult, as_tensor


def _host_rows(Q) -> np.ndarray:
    """The batch as a host array, the source of the cache keys."""
    if isinstance(Q, torch.Tensor):
        return Q.detach().cpu().numpy()
    return np.asarray(Q)


def _lut_to_host(lut):
    """Host copy of a LUT pack ((b, Dp, K) tensor or (qlut, scales))."""
    if isinstance(lut, tuple):
        return tuple(p.cpu().numpy() for p in lut)
    return lut.cpu().numpy()


def _lut_row(lut_host, i: int):
    """Row ``i`` of a host LUT pack: the per-query cache value."""
    if isinstance(lut_host, tuple):
        return tuple(p[i] for p in lut_host)
    return lut_host[i]


def _stack_lut_rows(rows):
    """Cached per-query rows back into a batch pack."""
    if isinstance(rows[0], tuple):
        return tuple(np.stack([r[j] for r in rows])
                     for j in range(len(rows[0])))
    return np.stack(rows)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def _pad_lut(lut, pad: int, dev: torch.device):
    """Zero-pad a LUT pack's query axis up to the bucket, on ``dev`` (rows
    assembled from the cache arrive as numpy)."""
    if isinstance(lut, tuple):
        return tuple(_pad_lut(p, pad, dev) for p in lut)
    if isinstance(lut, np.ndarray):
        lut = torch.from_numpy(lut).to(dev)
    return _pad_rows(lut, pad)


class Pending(NamedTuple):
    """A submitted batch: launched, not yet waited for. Hand it to
    ``Engine.collect`` once; the request is counted there."""

    res: SearchResult          # sliced back to the request's b rows
    batch: int
    bucket: int
    k: int
    nprobe: int | None
    lut_hits: int
    lut_misses: int
    t0: float                  # perf_counter at submit
    compiled_before: int | float
    done: Any                  # CUDA event after the launches, or None


class Engine:
    """Batching serving front end over one Searcher and its state (not
    thread-safe; one Engine per serving thread).

    ``lut_cache_rows`` bounds the LUT cache in entries, each a (Dp, K)
    float32 row on the host (32 KiB at Dp = 32, K = 256). The cache trades
    one device-to-host copy of the missed tables per batch for reuse on
    repeats; ``lut_cache_rows=0`` turns it (and the prepared path) off.

    ``probe`` (an ``obs.RecallProbe``) is replayed through ``search()``
    every ``probe.every`` requests and counted like any request.
    """

    def __init__(self, searcher, state: Any, *, k: int = 10,
                 nprobe: int | None = None, min_bucket: int = 8,
                 max_bucket: int = 4096, lut_cache_rows: int = 8192,
                 history: int = 512, probe: obs.RecallProbe | None = None):
        self.searcher = searcher
        self.state = state
        self.k = k
        self.nprobe = nprobe
        self.min_bucket = max(1, min_bucket)
        self.max_bucket = max(self.min_bucket, max_bucket)
        self.lut_cache_rows = lut_cache_rows
        self.history = history

        self._takes_nprobe = "nprobe" in inspect.signature(
            searcher.search).parameters
        if nprobe is not None and not self._takes_nprobe:
            raise ValueError(
                f"{type(searcher).__name__} does not take nprobe — an "
                "nprobe setting on this Engine would be silently ignored")
        self._jit = bool(getattr(searcher, "engine_jit", True))
        self._prepared_ok = self._jit and lut_cache_rows > 0 and all(
            hasattr(searcher, m)
            for m in ("rotate_queries", "luts", "search_prepared"))
        self._compiled: dict[tuple, Any] = {}
        # per-query LUT rows, keyed by (raw query bytes, lut_dtype, epoch);
        # the epoch advances whenever a refresh invalidates the tables
        self._luts: collections.OrderedDict[tuple, Any] = \
            collections.OrderedDict()
        self._epoch = 0

        self.obs = obs.Registry(enabled=True, window=max(1, history))
        self._latency = self.obs.distribution("engine.latency_ms")
        self._scanned = self.obs.distribution("engine.scanned_rows")
        self._pad_waste = self.obs.distribution("engine.pad_waste")
        self._counters = {
            name: self.obs.counter(f"engine.{name}")
            for name in ("requests", "queries", "compiles", "refreshes",
                         "lut_hits", "lut_misses", "lut_invalidations",
                         "lut_evictions")}
        self.probe = probe
        self._in_probe = False

    # -- shape bucketing ---------------------------------------------------
    def _bucket(self, b: int) -> int:
        bucket = self.min_bucket
        while bucket < b:
            bucket *= 2
        # chunking keeps b <= max_bucket, so the clamp still covers b
        return min(bucket, self.max_bucket)

    # -- executables -------------------------------------------------------
    def _nprobe_key(self, nprobe: int | None) -> int | None:
        """The probe width served, clamped by the backend (ivf caps at
        num_lists), so oversized requests share one executable."""
        if not self._takes_nprobe:
            if nprobe is not None:
                raise ValueError(
                    f"{type(self.searcher).__name__} does not take nprobe")
            return None
        npb = self.nprobe if nprobe is None else nprobe
        if npb is not None and npb < 1:
            raise ValueError(f"nprobe must be >= 1, got {npb}")
        if hasattr(self.searcher, "effective_nprobe"):
            npb = self.searcher.effective_nprobe(self.state, npb)
        return npb

    def _executable(self, path: str, bucket: int, k: int,
                    nprobe: int | None):
        """The callable of one key, made (and counted as a compile) on
        first use."""
        key = (path, bucket, k, nprobe)
        fn = self._compiled.get(key)
        if fn is None:
            kw = {} if nprobe is None else {"nprobe": nprobe}
            method = getattr(self.searcher, "search" if path == "plain"
                             else "search_prepared")

            def fn(*args):
                return method(*args, k=k, **kw)

            self._compiled[key] = fn
            if self._jit:
                self._counters["compiles"].inc()
        return fn

    # -- per-query LUT cache -----------------------------------------------
    def _lut_key(self, row: np.ndarray) -> tuple:
        """Cache key of one query row: its raw bytes, the LUT precision
        (an int8 pack row is not a float32 row) and the epoch."""
        return (row.tobytes(),
                getattr(self.state, "lut_dtype", "float32"),
                self._epoch)

    def _gather_luts(self, Qnp: np.ndarray, QR: torch.Tensor):
        """LUT rows for every query from the cache, building the misses
        from the rotated batch ``QR``. Returns (pack, hits, misses), both
        counted per served row; a row repeated inside one batch is built
        once."""
        keys = [self._lut_key(row) for row in Qnp]
        hits = 0
        need, seen = [], set()
        for i, kb in enumerate(keys):
            if kb in self._luts:
                hits += 1
                self._luts.move_to_end(kb)  # most recent: not evicted below
            elif kb not in seen:
                seen.add(kb)
                need.append(i)
        misses = len(keys) - hits
        if misses == len(keys) and len(need) == len(keys):
            # all miss, all distinct: serve the device tables directly; the
            # host copy only feeds the cache
            lut_dev = self.searcher.luts(self.state, QR)
            lut_host = _lut_to_host(lut_dev)
            for i, kb in enumerate(keys):
                self._luts[kb] = _lut_row(lut_host, i)
            self._evict()
            return lut_dev, hits, misses
        if need:
            idx = torch.as_tensor(need, device=QR.device)
            lut_m = _lut_to_host(self.searcher.luts(self.state, QR[idx]))
            for j, i in enumerate(need):
                self._luts[keys[i]] = _lut_row(lut_m, j)
        # read every row before evicting: a batch wider than the cache must
        # still assemble; eviction trims for the next request
        rows = _stack_lut_rows([self._luts[kb] for kb in keys])
        self._evict()
        return rows, hits, misses

    def _evict(self) -> None:
        """Trim to the capacity, least recently used first, counting each
        eviction."""
        while len(self._luts) > self.lut_cache_rows:
            self._luts.popitem(last=False)
            self._counters["lut_evictions"].inc()

    # -- serving -----------------------------------------------------------
    def submit(self, Q, *, k: int | None = None,
               nprobe: int | None = None) -> Pending:
        """Launch one (b, n) batch (1 ≤ b ≤ ``max_bucket``) and return a
        ``Pending`` for ``collect`` without waiting for the card (see the
        module docstring for the host syncs that remain)."""
        b = Q.shape[0]
        if b == 0:
            raise ValueError("empty query batch")
        if b > self.max_bucket:
            raise ValueError(
                f"submit is bounded by max_bucket={self.max_bucket} "
                f"(got {b}); search() chunks oversized batches")
        k = self.k if k is None else k
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        npb = self._nprobe_key(nprobe)
        bucket = self._bucket(b)
        pad = bucket - b
        compiled_before = self._counters["compiles"].value
        t0 = time.perf_counter()

        lut_hits = lut_misses = 0
        if self._prepared_ok:
            # the cache keys on the raw query bytes: the one place the
            # batch visits the host; the rotation reads Q as given
            Qnp = _host_rows(Q)
            QR = self.searcher.rotate_queries(self.state, Q)
            lut, lut_hits, lut_misses = self._gather_luts(Qnp, QR)
            fn = self._executable("prepared", bucket, k, npb)
            res = fn(self.state, _pad_rows(QR, pad),
                     _pad_lut(lut, pad, QR.device))
        else:
            fn = self._executable("plain", bucket, k, npb)
            res = fn(self.state, _pad_rows(as_tensor(Q), pad))

        res = SearchResult(scores=res.scores[:b], ids=res.ids[:b],
                           scanned=res.scanned[:b])
        done = None
        if res.scores.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(res.scores.device))
        return Pending(res=res, batch=b, bucket=bucket, k=k, nprobe=npb,
                       lut_hits=lut_hits, lut_misses=lut_misses, t0=t0,
                       compiled_before=compiled_before, done=done)

    def collect(self, pending: Pending) -> SearchResult:
        """Wait for a submitted batch and record the request: latency from
        submit to result-ready, LUT hits and misses, one request event.
        Call once per Pending."""
        res = pending.res
        if pending.done is not None:
            pending.done.synchronize()
        latency_ms = (time.perf_counter() - pending.t0) * 1e3

        scanned_rows = float(res.scanned.float().mean())
        self._counters["requests"].inc()
        self._counters["queries"].inc(pending.batch)
        self._counters["lut_hits"].inc(pending.lut_hits)
        self._counters["lut_misses"].inc(pending.lut_misses)
        self._latency.observe(latency_ms)
        self._scanned.observe(scanned_rows)
        self._pad_waste.observe(
            (pending.bucket - pending.batch) / pending.bucket)
        self.obs.event(
            "request", batch=pending.batch, bucket=pending.bucket,
            k=pending.k, nprobe=pending.nprobe, latency_ms=latency_ms,
            scanned_rows=scanned_rows, lut_hits=pending.lut_hits,
            lut_misses=pending.lut_misses,
            compiled=(self._counters["compiles"].value
                      > pending.compiled_before))

        if self.probe is not None and not self._in_probe:
            self._in_probe = True
            try:
                self.probe.maybe_run(
                    lambda pq: self.search(pq, k=self.probe.k))
            finally:
                self._in_probe = False
        return res

    def search(self, Q, *, k: int | None = None,
               nprobe: int | None = None) -> SearchResult:
        """Serve one (b, n) batch (any b ≥ 1) at top-``k``:
        ``collect(submit(...))``, chunking batches beyond ``max_bucket``."""
        b = Q.shape[0]
        if b == 0:
            raise ValueError("empty query batch")
        if b > self.max_bucket:
            parts = [self.collect(self.submit(Q[i:i + self.max_bucket],
                                              k=k, nprobe=nprobe))
                     for i in range(0, b, self.max_bucket)]
            return SearchResult(
                scores=torch.cat([p.scores for p in parts]),
                ids=torch.cat([p.ids for p in parts]),
                scanned=torch.cat([p.scanned for p in parts]))
        return self.collect(self.submit(Q, k=k, nprobe=nprobe))

    # -- live rotation refresh --------------------------------------------
    def refresh(self, delta) -> None:
        """Absorb a rotation learner's step between batches. The LUT cache
        is cleared (tables depend on R) unless the backend proves them
        exactly invariant across this delta (``luts_refresh_invariant``);
        then the cache and its epoch survive. Executables survive either
        way."""
        R = self._live_rot()
        if R is not None:
            n = int(R.shape[-1])
            pi = getattr(delta, "pi", None)
            if pi is not None and pi.numel():
                top = int(torch.maximum(pi.max(), delta.pj.max()))
                if top >= n:
                    raise ValueError(
                        f"refresh: delta rotates pairs up to index {top} but "
                        f"the live rotation is {n}x{n} — the trainer's "
                        "manifold leaf and this index have different "
                        "dimensions")
        keep = (hasattr(self.searcher, "luts_refresh_invariant")
                and self.searcher.luts_refresh_invariant(self.state, delta))
        with self.obs.span("engine.refresh") as sp:
            self.state = self.searcher.refresh(self.state, delta)
            sp.sync(self.state)
        if not keep:
            self._luts.clear()
            self._epoch += 1
            self._counters["lut_invalidations"].inc()
        self._counters["refreshes"].inc()
        if obs.enabled():
            # delta norm and orthogonality drift on the global registry: a
            # host sync on the (n, n) rotation, so only when someone watches
            from repro_torch.index import maintain

            R = self._live_rot()
            if R is not None:
                maintain.refresh_health(R, delta)

    def _live_rot(self):
        """The live rotation: ``state.rot`` in fused quantized mode (the
        index keeps R₀ there), else ``state.R`` (exact) or
        ``state.index.R`` (eager quantized)."""
        R = getattr(self.state, "rot", None)
        if R is None:
            R = getattr(self.state, "R", None)
        if R is None:
            R = getattr(getattr(self.state, "index", None), "R", None)
        return R

    # -- observability -----------------------------------------------------
    @property
    def requests(self) -> list[dict]:
        """The retained per-request records (newest last, at most
        ``history``), read from the registry's event window."""
        return [{k: v for k, v in rec.items() if k not in ("kind", "t")}
                for rec in self.obs.events("request")]

    def stats(self) -> dict:
        """Serving stats and the backend's static facts.

        Counters (``requests``, ``queries``, ``compiles``, ``executables``,
        ``refreshes``, ``lut_*``) are lifetime totals; the latency, scanned
        rows and pad waste aggregates cover the retained window of the last
        ``window["size"]`` requests (at most ``history``)."""
        lat = self._latency.summary()
        c = {name: m.value for name, m in self._counters.items()}
        looked = c["lut_hits"] + c["lut_misses"]
        out = dict(
            requests=c["requests"],
            queries=c["queries"],
            compiles=c["compiles"],
            executables=len(self._compiled),
            refreshes=c["refreshes"],
            lut_hits=c["lut_hits"],
            lut_misses=c["lut_misses"],
            lut_hit_rate=(c["lut_hits"] / looked if looked else 0.0),
            lut_cached_rows=len(self._luts),
            lut_evictions=c["lut_evictions"],
            lut_invalidations=c["lut_invalidations"],
            lut_epoch=self._epoch,
            window=dict(size=lat.get("window", 0),
                        capacity=self.history,
                        scope="latency/scanned/pad aggregates"),
            window_requests=lat.get("window", 0),
            latency_ms_mean=lat.get("mean", 0.0),
            latency_ms_p50=lat.get("p50", 0.0),
            latency_ms_p95=lat.get("p95", 0.0),
            latency_ms_p99=lat.get("p99", 0.0),
            latency_ms_max=(max(self._latency.window_values())
                            if lat.get("window") else 0.0),
            scanned_rows_mean=self._scanned.summary().get("mean", 0.0),
            pad_waste_mean=self._pad_waste.summary().get("mean", 0.0),
            searcher=self.searcher.stats(self.state),
        )
        if self.probe is not None:
            out["recall_probe"] = dict(k=self.probe.k,
                                       recall=self.probe.last,
                                       every=self.probe.every)
        out["churn"] = self._churn_stats()
        return out

    def _churn_stats(self) -> dict:
        """The live-churn block of ``stats()``, all zeros until churn is
        ported (ROADMAP.md queue 5); the keys are the JAX Engine's."""
        return dict(
            staged_rows=0.0, tombstoned_rows=0.0, staged=0, flushed=0,
            tombstoned=0, flushes=0, compactions=0, rebalances=0, grows=0,
            flush_ms_p95=0.0, bg_submitted=0, bg_compactions=0,
            bg_discarded=0, flushes_deferred=0, reencoded=0,
            compact_hidden_ms_total=0.0,
            window=dict(size=0, capacity=self.history,
                        scope="flush_ms aggregates"))
