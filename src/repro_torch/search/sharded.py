"""Row-sharded searchers: the corpus partitioned over a data mesh (port of
``repro/search/sharded.py``).

Every replicated backend has a ``*_sharded`` twin that keeps the serving
transform and the SearchResult contract while the corpus rows live
partitioned over the shards of a ``launch.mesh.DataMesh``:

  exact_sharded    per-shard tiled brute-force scan of the local rows
  flat_sharded     per-shard flat ADC scan of the local CSR codes
  ivf_sharded      per-shard probe and scan: every shard probes the same
                   top-``nprobe`` lists of the shared coarse quantizer but
                   scans only its own blocks of them

One process drives every shard, as the JAX package's single-controller
``shard_map`` does: shard ``s``'s tensors (rotated corpus or CSR codes,
ids, list offsets) live on ``mesh.devices[s]``, and R, the coarse
centroids and the residual codebooks are replicated onto each device (on
a device that holds several shards, one copy serves them all). Each shard
runs the single-device scan and emits a padded local top-k under the
−inf/−1 contract, also when k exceeds its pool; the merge copies every
shard's (b, k) run to the queries' device (the first shard's) and re-ranks
them with ``kernels.ops.topk_merge``, the tie rule of ``topk_padded``
(equal scores by ascending id). ``scanned`` is the sum over shards, in
shard order. So a sharded backend built (or ``attach``-ed) from the same
index returns its replicated twin's scores: each row's score comes from
the same kernel on the same codes under the same LUT, and the merge only
reorders.

The IVF and flat bodies run in two passes over the shards: every shard's
scan is launched first, then each shard's top-k, whose candidate cut
(``index.search._candidates``) reads one number back to the host. The
first of those S reads waits for all S scans; the others only for the
top-k before them.

A shard's CSR is padded to the common capacity with hole rows after its
sentinel block (``attach_shards``), so shard ``s`` holds row ``s`` of the
JAX package's stacked state bit for bit. The probe window ``max_blocks``
is the largest over the shards; out-of-range window tiles read each
shard's last block, which is all holes, and the flat scan masks holes by
id.

``refresh`` applies the (small, replicated) RotationDelta to R, the
centroids and the codebooks and copies them to each shard's device; the
per-shard CSRs are untouched, so the Engine keeps its executables. Under
fused refresh only the query-side matrices move.

    mesh = launch.mesh.make_data_mesh(4, devices=("cuda:0",) * 4)
    searcher = search.make("ivf_sharded", mesh=mesh)
    state = searcher.attach(index, mesh=mesh, nprobe=32)
    engine = search.Engine(searcher, state, k=10, nprobe=32)
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from repro_torch import obs, quant, rotations
from repro_torch.churn import buffer as churn_buffer
from repro_torch.index import ivf as index_ivf
from repro_torch.index import maintain
from repro_torch.index import search as index_search
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.kernels import ops as kops
from repro_torch.search import exact as exact_mod
from repro_torch.search import flat as flat_mod
from repro_torch.search.base import SearchConfig, SearchResult, rotate
from repro_torch.sharding import rules as sh

AxisSpec = str | tuple[str, ...]


def resolve_mesh(mesh=None, axis: AxisSpec = "auto"):
    """The serving mesh: ``mesh``, else one shard on each visible card
    (``launch.mesh.make_data_mesh()``). The port has no ambient mesh."""
    if mesh is not None:
        return mesh
    from repro_torch.launch.mesh import make_data_mesh

    return make_data_mesh()


def resolve_axes(mesh, axis: AxisSpec = "auto") -> tuple[str, ...]:
    """The mesh axes the corpus rows shard over. ``"auto"`` takes the
    axes of ``IVF_SHARDED_RULES["ivf_rows"]`` (("pod", "data")) that the
    mesh has, so the shard count is the full product of the row axes: a
    (2, 4) pod × data mesh shards 8 ways."""
    if axis == "auto" or axis is None:
        rule = sh.IVF_SHARDED_RULES["ivf_rows"]
        kept = tuple(a for a in rule if a in mesh.shape)
        if not kept:
            raise ValueError(f"mesh {dict(mesh.shape)} has none of the "
                             f"row-shard axes {rule}")
        return kept
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(
                f"mesh {dict(mesh.shape)} has no {a!r} axis to shard over")
    return axes


def _num_shards(mesh, axes: tuple[str, ...]) -> int:
    """Shards of the row axes; they must cover every device of the mesh
    (one shard a device: the port never replicates a shard)."""
    S = math.prod(mesh.shape[a] for a in axes)
    if S != len(mesh.devices):
        raise ValueError(
            f"rows shard {S} ways over {axes!r} but the mesh has "
            f"{len(mesh.devices)} devices: shard over all of its axes")
    return S


def _check_device(mesh, device) -> None:
    """A sharded build's ``device`` (the Searcher protocol's keyword) must
    be None or the mesh's first device: the mesh places the shards."""
    from repro_torch.launch.mesh import normal_device

    if device is not None and normal_device(device) != mesh.devices[0]:
        raise ValueError(f"a sharded build runs on its mesh "
                         f"({mesh.devices[0]} first), not on {device}")


def _to(obj, dev: torch.device):
    """``obj`` (a tensor, or a dataclass of tensors: a quantizer, a delta)
    on ``dev``; the same object when it is there already."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev)
    moved = {f.name: _to(getattr(obj, f.name), dev)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    if all(moved[k] is getattr(obj, k) for k in moved):
        return obj
    return dataclasses.replace(obj, **moved)


def _lut_to(lut, dev: torch.device):
    """A LUT pack (tensor or (qlut, scales)) on ``dev``."""
    if isinstance(lut, tuple):
        return tuple(_to(p, dev) for p in lut)
    return _to(lut, dev)


def _merge_runs(runs: list, k: int, head: torch.device) -> SearchResult:
    """Every shard's padded (b, k) run on the queries' device, re-ranked
    (ties by ascending id); ``scanned`` summed in shard order."""
    with obs.span("gather_merge"):
        scores = torch.cat([_to(r.scores, head) for r in runs], dim=1)
        ids = torch.cat([_to(r.ids, head) for r in runs], dim=1)
        top_s, top_i = kops.topk_merge(scores, ids, k)
        scanned = _to(runs[0].scanned, head)
        for r in runs[1:]:
            scanned = scanned + _to(r.scanned, head)
    return SearchResult(scores=top_s, ids=top_i, scanned=scanned)


def _shard_rows_stats(ids) -> dict:
    """The per-shard occupancy every sharded ``stats()`` reports."""
    rows = np.asarray([int(torch.sum(t >= 0)) for t in ids])
    return dict(rows_per_shard=[int(r) for r in rows],
                shard_imbalance=float(rows.max())
                / max(float(rows.mean()), 1.0))


def _record_shard_gauges(backend: str, ids) -> None:
    """Per-shard row gauges and the imbalance gauge on the global registry
    (``ids``: the per-shard id tensors, −1 = hole). Called at build and
    attach when ``obs.enabled()``; nothing on the query path."""
    reg = obs.default_registry()
    st = _shard_rows_stats(ids)
    for s, r in enumerate(st["rows_per_shard"]):
        reg.gauge("index.shard_rows", backend=backend, shard=s).set(r)
    reg.gauge("index.shard_imbalance", backend=backend).set(
        st["shard_imbalance"])
    reg.event("shard_layout", backend=backend,
              shards=len(st["rows_per_shard"]), rows=st["rows_per_shard"],
              imbalance=st["shard_imbalance"])


# ---------------------------------------------------------------------------
# exact_sharded
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedExactState:
    """The rotated corpus, one zero-padded slice a shard on its device;
    R (and the fused mode's frozen R₀) on the first shard's device."""

    R: torch.Tensor             # (n, n) serving rotation
    XR: tuple                   # S × (rows_s, n) rotated corpus
    ids: tuple                  # S × (rows_s,) int32 item ids, −1 = pad
    mesh: object
    tile_rows: int = 4096
    axes: tuple = ("data",)
    R0: torch.Tensor | None = None

    @property
    def num_shards(self) -> int:
        return len(self.XR)


@dataclasses.dataclass(frozen=True)
class ExactSharded:
    """Registry backend ``"exact_sharded"`` (see the module docstring)."""

    name: ClassVar[str] = "exact_sharded"
    mesh: object = None
    axis: AxisSpec = "auto"

    def build(self, generator: torch.Generator | None, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *,
              device=None) -> ShardedExactState:
        """Rows 0 … N−1 in S contiguous slices of whole tiles, the last
        ones padded; deterministic, ``generator`` is not used."""
        mesh = resolve_mesh(self.mesh, self.axis)
        _check_device(mesh, device)
        axes = resolve_axes(mesh, self.axis)
        S = _num_shards(mesh, axes)
        head = mesh.devices[0]
        R = R.to(head, torch.float32)
        n_rows, n = corpus.shape
        rows_s = max(-(-n_rows // S), 1)
        tile = max(1, min(cfg.tile_rows, rows_s))
        rows_s = -(-rows_s // tile) * tile          # whole tiles a shard
        XR, ids = [], []
        for s, dev in enumerate(mesh.devices):
            lo, hi = min(s * rows_s, n_rows), min((s + 1) * rows_s, n_rows)
            xr = corpus[lo:hi].to(head, torch.float32) @ R
            xr = torch.cat([xr, xr.new_zeros((rows_s - (hi - lo), n))])
            XR.append(_to(xr, dev))
            ids.append(exact_mod._tile_ids(lo, hi - lo, rows_s).to(dev))
        if obs.enabled():
            _record_shard_gauges(self.name, ids)
        return ShardedExactState(
            R=R, XR=tuple(XR), ids=tuple(ids), mesh=mesh, tile_rows=tile,
            axes=axes, R0=R if cfg.fused_refresh else None)

    def search(self, state: ShardedExactState, Q, *,
               k: int = 10) -> SearchResult:
        QR = rotate(Q, exact_mod._query_rotation(state))
        b = QR.shape[0]
        runs = []
        with obs.span("shard_scan"):
            for XR_s, ids_s, dev in zip(state.XR, state.ids,
                                        state.mesh.devices):
                top_s, top_i = exact_mod.scan_tiles(
                    _to(QR, dev), XR_s, ids_s, state.tile_rows, k)
                live = torch.sum(ids_s >= 0).to(torch.int32)
                runs.append(SearchResult(scores=top_s, ids=top_i,
                                         scanned=live.expand(b)))
        return _merge_runs(runs, k, QR.device)

    def refresh(self, state: ShardedExactState,
                delta) -> ShardedExactState:
        R = rotations.apply(state.R, delta)
        if state.R0 is not None:
            # fused: the frozen shards cancel the delta; only R moves
            return dataclasses.replace(state, R=R)
        XR = tuple(rotations.apply(x, _to(delta, x.device))
                   for x in state.XR)
        return dataclasses.replace(state, R=R, XR=XR)

    def stats(self, state: ShardedExactState) -> dict:
        rows = int(sum(int(torch.sum(t >= 0)) for t in state.ids))
        S = state.num_shards
        mem = sum(x.numel() * x.element_size() for x in state.XR)
        return dict(
            backend=self.name,
            devices=[str(d) for d in state.mesh.devices],
            rows=rows,
            capacity=sum(int(t.numel()) for t in state.ids),
            dim=int(state.R.shape[0]),
            shards=S,
            tile_rows=state.tile_rows,
            scan_rows_per_query=rows,
            scan_rows_per_query_per_device=rows / S,
            memory_bytes=int(mem),
            memory_bytes_per_device=int(mem) // S,
            compression=1.0,
            fused_refresh=state.R0 is not None,
            **_shard_rows_stats(state.ids),
        )


# ---------------------------------------------------------------------------
# flat_sharded / ivf_sharded: the quantized family over per-shard CSRs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedADCState:
    """Quantized sharded state: one CSR a shard, padded to a common
    capacity, each an ``IVFPQIndex`` on its device that shares R, the
    coarse quantizer and the residual quantizer (replicated; shard 0's
    are the head copies the queries and tables are made from).

    ``max_blocks`` is the largest list over the shards in tiles (every
    shard runs one schedule shape); ``rot``/``wacc``/``qdelta``/
    ``lut_cols`` are the fused-refresh matrices, on the head device.
    ``staging`` holds one append buffer a shard (``repro_torch.churn``),
    None until ``churn.with_staging``."""

    shards: tuple                      # S × IVFPQIndex
    mesh: object
    max_blocks: int
    nprobe: int = 8
    lut_dtype: str = "float32"
    axes: tuple = ("data",)
    rot: torch.Tensor | None = None
    wacc: torch.Tensor | None = None
    qdelta: torch.Tensor | None = None
    lut_cols: torch.Tensor | None = None
    staging: tuple | None = None       # S × StagingBuffer

    # the shared components (shard 0's copies) and the per-shard fields,
    # under the JAX state's names
    @property
    def R(self) -> torch.Tensor:
        return self.shards[0].R

    @property
    def coarse(self) -> quant.VQ:
        return self.shards[0].coarse

    @property
    def quantizer(self):
        return self.shards[0].quantizer

    @property
    def block_size(self) -> int:
        return self.shards[0].block_size

    @property
    def codes(self) -> tuple:
        return tuple(p.codes for p in self.shards)

    @property
    def ids(self) -> tuple:
        return tuple(p.ids for p in self.shards)

    @property
    def list_offsets(self) -> tuple:
        return tuple(p.list_offsets for p in self.shards)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_lists(self) -> int:
        return self.shards[0].num_lists

    @property
    def capacity(self) -> int:
        """Rows of each shard's CSR (the common, padded capacity)."""
        return self.shards[0].capacity


def _replicated(state: ShardedADCState, R, coarse, quantizer
                ) -> ShardedADCState:
    """``state`` with new shared components, copied to each shard's
    device (one copy a device)."""
    parts = tuple(dataclasses.replace(
        p, R=_to(R, d), coarse=_to(coarse, d), quantizer=_to(quantizer, d))
        for p, d in zip(state.shards, state.mesh.devices))
    return dataclasses.replace(state, shards=parts)


def _fused_sharded_state(state: ShardedADCState) -> ShardedADCState:
    """The fused-refresh matrices at the build rotation (Δ = W = I:
    rot = R₀, qdelta = I; ``flat._fused_state``)."""
    R = state.R
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    _, colmap = state.quantizer.lut_operands()
    return dataclasses.replace(state, rot=R, wacc=eye, qdelta=eye,
                               lut_cols=kops.lut_column_map(colmap))


def _same_fit(p: IVFPQIndex, head: IVFPQIndex) -> bool:
    def eq(a, b):
        return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())

    return (p.block_size == head.block_size and eq(p.R, head.R)
            and eq(p.coarse.centroids, head.coarse.centroids)
            and eq(p.quantizer.codebooks, head.quantizer.codebooks))


def attach_shards(parts: list, *, mesh=None, axis: AxisSpec = "auto",
                  nprobe: int = 8, lut_dtype: str = "float32",
                  fused_refresh: bool = False) -> ShardedADCState:
    """Serve per-shard indexes (``ivf.shard_split`` or
    ``ivf.build_sharded`` output) as one sharded state, part ``s`` on
    ``mesh.devices[s]``.

    Every part must share R, the coarse centroids, the residual codebooks
    and ``block_size``: serving decodes every shard against shard 0's
    quantizers, so independently fitted parts would give well-formed,
    wrong scores; they raise instead. Shorter parts are padded to the
    largest capacity with hole rows (id −1, code 0) after their sentinel
    block, which no offset names."""
    mesh = resolve_mesh(mesh, axis)
    axes = resolve_axes(mesh, axis)
    S = _num_shards(mesh, axes)
    if len(parts) != S:
        raise ValueError(
            f"{len(parts)} index shards for a {S}-way {axes!r} mesh")
    head = parts[0]
    for i, p in enumerate(parts[1:], start=1):
        if not _same_fit(p, head):
            raise ValueError(
                f"index shard {i} does not share shard 0's R/coarse/"
                "quantizer/block_size — sharded serving requires one fit "
                "across all shards (ivf.shard_split / ivf.build_sharded)")
    cap = max(p.capacity for p in parts)
    max_blocks = max(max(p.max_list_blocks() for p in parts), 1)
    dev0 = mesh.devices[0]
    R, coarse, quantizer = (_to(head.R, dev0), _to(head.coarse, dev0),
                            _to(head.quantizer, dev0))
    shards = []
    for p, dev in zip(parts, mesh.devices):
        extra = cap - p.capacity
        codes = torch.cat([p.codes, p.codes.new_zeros(
            (extra, p.codes.shape[1]))])
        ids = torch.cat([p.ids, p.ids.new_full((extra,), -1)])
        shards.append(IVFPQIndex(
            R=_to(R, dev), coarse=_to(coarse, dev),
            quantizer=_to(quantizer, dev), codes=_to(codes, dev),
            ids=_to(ids, dev), list_offsets=_to(p.list_offsets, dev),
            block_size=head.block_size))
    if obs.enabled():
        # one ShardedADCState serves both flat_sharded and ivf_sharded
        _record_shard_gauges("adc_sharded", [p.ids for p in shards])
    state = ShardedADCState(
        shards=tuple(shards), mesh=mesh, max_blocks=max_blocks,
        nprobe=min(nprobe, head.num_lists), lut_dtype=lut_dtype, axes=axes)
    return _fused_sharded_state(state) if fused_refresh else state


def _sharded_scan(state: ShardedADCState, QR: torch.Tensor, lut, k: int,
                  launch, finish) -> SearchResult:
    """Every shard's scan, then every shard's top-k (module docstring),
    each with its staged rows folded in by the flat-ADC side pass before
    the merge: staged rows never leave their shard.
    ``launch(index, QR, lut)`` starts a shard's scan, ``finish(index,
    launched, k)`` gives its padded (b, k) SearchResult."""
    devices = state.mesh.devices
    stg = state.staging or (None,) * len(devices)
    with obs.span("shard_scan"):
        ins = [(_to(QR, d), _lut_to(lut, d)) for d in devices]
        launched = [launch(p, q, lt) for p, (q, lt) in zip(state.shards, ins)]
        runs = []
        for p, (q, lt), go, buf in zip(state.shards, ins, launched, stg):
            res = finish(p, go, k)
            if buf is not None:
                res = churn_buffer.merge_staged(res, buf, q, lt,
                                                p.centroids, k)
            runs.append(res)
    return _merge_runs(runs, k, QR.device)


def _flat_launch(index: IVFPQIndex, QR, lut):
    return index_search.flat_adc_prepared(index, QR, lut)


def _flat_finish(index: IVFPQIndex, launched, k: int) -> SearchResult:
    scores, cand_ids = launched
    top_s, top_i = index_search.topk_padded(scores, cand_ids, k)
    scanned = torch.full((scores.shape[0],), index.capacity,
                         dtype=torch.int32, device=scores.device)
    return SearchResult(scores=top_s, ids=top_i, scanned=scanned)


def _flat_sharded_prepared(state: ShardedADCState, QR, lut,
                           k: int) -> SearchResult:
    return _sharded_scan(state, QR, lut, k, _flat_launch, _flat_finish)


def _ivf_sharded_prepared(state: ShardedADCState, QR, lut, k: int,
                          nprobe: int) -> SearchResult:
    # every shard probes the same lists of the shared coarse quantizer
    # (replicated O(b·L) work) and scans only its own blocks of them
    def launch(index, q, lt):
        return index_search.scan_scores(index, q, lt, nprobe=nprobe,
                                        max_blocks=state.max_blocks)

    return _sharded_scan(state, QR, lut, k, launch, index_search.scan_topk)


def _sharded_refresh(state: ShardedADCState, delta) -> ShardedADCState:
    """Apply the replicated delta: R, the centroids and the codebooks
    rotate on the head device and are copied to each shard's; every
    shard's CSR stays. Fused: only the query-side matrices move."""
    maintain.check_refreshable(delta)
    if state.rot is not None:
        rot, wacc, qdelta = flat_mod._fused_refresh_mats(
            state.R, state.rot, state.wacc, delta.pi, delta.pj, delta.theta,
            state.quantizer.sub)
        return dataclasses.replace(state, rot=rot, wacc=wacc, qdelta=qdelta)
    R, coarse, quantizer = maintain.rotate_components(
        state.R, state.coarse, state.quantizer, delta.pi, delta.pj,
        delta.theta)
    return _replicated(state, R, coarse, quantizer)


def _sharded_luts_refresh_invariant(state: ShardedADCState, delta) -> bool:
    """``flat._luts_refresh_invariant`` on the shared quantizer: fused
    mode and a purely within-subspace disjoint GivensDelta."""
    if state.rot is None or not isinstance(delta, rotations.GivensDelta):
        return False
    if delta.overlapping:
        return False
    sub = state.quantizer.sub
    pi = delta.pi.cpu().numpy()
    pj = delta.pj.cpu().numpy()
    return bool(((pi // sub) == (pj // sub)).all())


def _sharded_adc_stats(name: str, state: ShardedADCState) -> dict:
    S = state.num_shards
    live = int(sum(int(torch.sum(t >= 0)) for t in state.ids))
    codes0 = state.codes[0]
    code_bytes = int(codes0.shape[-1] * codes0.element_size())
    mem = int(sum(c.numel() * c.element_size() for c in state.codes))
    return dict(
        backend=name,
        devices=[str(d) for d in state.mesh.devices],
        rows=live,
        capacity=state.capacity * S,
        dim=int(state.coarse.dim),
        shards=S,
        num_lists=state.num_lists,
        code_bytes_per_row=code_bytes,
        compression=float(state.coarse.dim * 4 / code_bytes),
        memory_bytes=mem,
        memory_bytes_per_device=mem // S,
        lut_dtype=state.lut_dtype,
        fused_refresh=state.rot is not None,
        **_shard_rows_stats(state.ids),
    )


def _shard_existing(index: IVFPQIndex, mesh, axis: AxisSpec, *, nprobe: int,
                    lut_dtype: str = "float32",
                    fused_refresh: bool = False) -> ShardedADCState:
    mesh = resolve_mesh(mesh, axis)
    axes = resolve_axes(mesh, axis)
    parts = index_ivf.shard_split(index, _num_shards(mesh, axes))
    return attach_shards(parts, mesh=mesh, axis=axes, nprobe=nprobe,
                         lut_dtype=lut_dtype, fused_refresh=fused_refresh)


def _rotate_queries(state: ShardedADCState, Q) -> torch.Tensor:
    # fused mode keeps R at R₀ and the coarse term is exactly invariant,
    # so Q·R is the query rotation in both modes
    return rotate(Q, state.R)


def _luts(state: ShardedADCState, QR: torch.Tensor):
    """The per-query LUT pack over the shared residual quantizer, made on
    the head device as ``flat._luts`` makes it; each shard reads a copy
    on its own device."""
    if state.qdelta is None:
        return index_search.build_luts(state.quantizer, QR, state.lut_dtype)
    cb_flat, colmap = state.quantizer.lut_operands()
    lut = kops.fused_lut(QR.contiguous(), state.qdelta.contiguous(),
                         cb_flat.contiguous(), colmap, cols=state.lut_cols)
    if state.lut_dtype != "float32":
        return kops.quantize_luts(lut, state.lut_dtype)
    return lut


class _ShardedADC:
    """What flat_sharded and ivf_sharded share (one state serves both)."""

    @staticmethod
    def attach(index: IVFPQIndex, *, mesh=None, axis: AxisSpec = "auto",
               nprobe: int = 8, lut_dtype: str = "float32",
               fused_refresh: bool = False) -> ShardedADCState:
        """Shard an existing replicated index over the mesh: the very
        codes the single-device backends serve, redistributed by
        ``ivf.shard_split`` (the parity and migration entry point)."""
        return _shard_existing(index, mesh, axis, nprobe=nprobe,
                               lut_dtype=lut_dtype,
                               fused_refresh=fused_refresh)

    def build(self, generator: torch.Generator, corpus: torch.Tensor,
              R: torch.Tensor, cfg: SearchConfig, *,
              device=None) -> ShardedADCState:
        """``ivf.build`` on the mesh's first device, then ``attach``."""
        mesh = resolve_mesh(self.mesh, self.axis)
        _check_device(mesh, device)
        index = index_ivf.build(generator, corpus, R, cfg.ivf_config(),
                                train_size=cfg.train_size,
                                device=mesh.devices[0])
        return self.attach(index, mesh=mesh, axis=self.axis,
                           nprobe=cfg.nprobe, lut_dtype=cfg.lut_dtype,
                           fused_refresh=cfg.fused_refresh)

    # -- Engine LUT-cache capabilities -------------------------------------
    def rotate_queries(self, state: ShardedADCState, Q) -> torch.Tensor:
        return _rotate_queries(state, Q)

    def luts(self, state: ShardedADCState, QR: torch.Tensor):
        return _luts(state, QR)

    def luts_refresh_invariant(self, state: ShardedADCState, delta) -> bool:
        return _sharded_luts_refresh_invariant(state, delta)

    def refresh(self, state: ShardedADCState, delta) -> ShardedADCState:
        return _sharded_refresh(state, delta)


@dataclasses.dataclass(frozen=True)
class FlatSharded(_ShardedADC):
    """Registry backend ``"flat_sharded"`` (see the module docstring)."""

    name: ClassVar[str] = "flat_sharded"
    mesh: object = None
    axis: AxisSpec = "auto"

    def search(self, state: ShardedADCState, Q, *,
               k: int = 10) -> SearchResult:
        QR = _rotate_queries(state, Q)
        return _flat_sharded_prepared(state, QR, _luts(state, QR), k)

    def search_prepared(self, state: ShardedADCState, QR, lut, *,
                        k: int = 10) -> SearchResult:
        return _flat_sharded_prepared(state, QR, lut, k)

    def stats(self, state: ShardedADCState) -> dict:
        st = _sharded_adc_stats(self.name, state)
        st["scan_rows_per_query"] = st["capacity"]
        st["scan_rows_per_query_per_device"] = state.capacity
        return st


@dataclasses.dataclass(frozen=True)
class IVFSharded(_ShardedADC):
    """Registry backend ``"ivf_sharded"`` (see the module docstring)."""

    name: ClassVar[str] = "ivf_sharded"
    mesh: object = None
    axis: AxisSpec = "auto"

    def effective_nprobe(self, state: ShardedADCState,
                         nprobe: int | None) -> int:
        """Engine capability: the probe width served, capped at the
        shared coarse quantizer's list count."""
        return min(state.nprobe if nprobe is None else nprobe,
                   state.num_lists)

    def prepare_state(self, state: ShardedADCState) -> ShardedADCState:
        """Engine capability: the probe window of a state made by hand
        (``attach_shards`` sets it; one host read of the offsets
        otherwise)."""
        if state.max_blocks >= 1:
            return state
        return dataclasses.replace(state, max_blocks=max(
            p.max_list_blocks() for p in state.shards))

    def search(self, state: ShardedADCState, Q, *, k: int = 10,
               nprobe: int | None = None) -> SearchResult:
        state = self.prepare_state(state)
        QR = _rotate_queries(state, Q)
        return _ivf_sharded_prepared(state, QR, _luts(state, QR), k,
                                     self.effective_nprobe(state, nprobe))

    def search_prepared(self, state: ShardedADCState, QR, lut, *,
                        k: int = 10,
                        nprobe: int | None = None) -> SearchResult:
        state = self.prepare_state(state)
        return _ivf_sharded_prepared(state, QR, lut, k,
                                     self.effective_nprobe(state, nprobe))

    def stats(self, state: ShardedADCState) -> dict:
        st = _sharded_adc_stats(self.name, state)
        st["nprobe"] = state.nprobe
        st["max_blocks"] = state.max_blocks
        per_shard = min(state.nprobe * state.max_blocks * state.block_size,
                        state.capacity)
        st["scan_rows_per_query"] = per_shard * state.num_shards
        st["scan_rows_per_query_per_device"] = per_shard
        return st
