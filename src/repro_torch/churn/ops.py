"""Churn primitives: stage, flush, tombstone, compact, rebalance (port of
``repro/churn/ops.py``).

Every primitive takes a servable state and returns a new one, and keeps
every shape the serving path can see wherever it can:

  * ``tombstone``: O(1) deletes by flipping ids to −1 (CSR, staging and
    exact corpora alike); the scans' id mask makes those rows −inf on the
    next query. Nothing is reshaped.
  * ``stage``: encode new rows against the state's quantizers and park
    them in free staging slots (``churn.buffer``); raises when the buffer
    is full, so the caller can flush or compact first.
  * ``flush``: fold staged rows into the CSR holes of their lists. Holes
    only: offsets and shapes stay, and rows whose list has no hole stay
    staged.
  * ``compact``: repack the live (and, by default, the staged) rows into a
    fresh block-aligned CSR on the host, as ``ivf.pack`` does. The capacity
    is padded back to the old one whenever the live rows fit, so balanced
    churn swaps tensors of the same shapes under the Engine; a corpus that
    really grew returns larger tensors (and maybe a larger ``max_blocks``),
    which the controller counts as a grow.
  * ``shard_rebalance``: the sharded form of ``ivf.shard_split``: gather
    every live (and staged) row of a sharded state, re-partition by id
    rank, repack each shard. Codes are carried, never re-encoded.

The sharded states (``search.sharded``) keep one CSR and one staging
buffer a shard, each on its shard's device: ``stage`` puts each new row
in the shard with the most free slots, ``flush`` and ``compact`` work
shard by shard, and the host plans read the per-shard ids as the JAX
package reads its stacked arrays.

States never share a tensor that a primitive writes: a primitive that
changes ``ids``, ``codes`` or a staging tensor clones it first (or builds
it with ``torch.where``/``torch.cat``), so a snapshot taken earlier (the
background compactor's, or a batch the Engine has launched and not yet
collected) keeps reading what it read.

Where the JAX package works on the host (the slot choice of ``stage``,
``flush``, ``compact``, the staleness re-encode's gather), so does this
port: ``flush`` copies the CSR's ids (4 bytes a row) to the host to plan
its moves, then moves the rows on the device; ``compact`` copies the live
codes and ids to the host for ``ivf.pack``. The slot choice of ``stage`` is
made on the device from the buffer's ids.

States are told apart by their fields (``_kind``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.churn import buffer as churn_buffer
from repro_torch.churn.buffer import StagingBuffer
from repro_torch.index import ivf as index_ivf
from repro_torch.index.ivf import IVFPQIndex

# ---------------------------------------------------------------------------
# State dispatch
# ---------------------------------------------------------------------------


def _kind(state) -> str:
    """Which churn family a state belongs to, by its fields (no
    ``repro_torch.search`` import: the searchers import ``churn.buffer``)."""
    if isinstance(state, IVFPQIndex):
        return "index"
    if hasattr(state, "index"):                    # search.flat.ADCState
        return "adc"
    if hasattr(state, "tiles"):                    # StreamingExactState
        return "exact_stream"
    if hasattr(state, "list_offsets"):             # ShardedADCState
        return "sharded_adc"
    if hasattr(state, "XR"):                       # Exact(/Sharded)State
        return "sharded_exact" if isinstance(state.XR, tuple) else "exact"
    raise TypeError(
        f"{type(state).__name__} is not a churn-capable state (expected an "
        "IVFPQIndex or an ADC or exact searcher state)")


def _as_ids(ids, device) -> torch.Tensor:
    """Item ids (array, list or tensor) as an int32 tensor on ``device``."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.array(ids, dtype=np.int32).reshape(-1))
    return ids.to(device=device, dtype=torch.int32)


def _as_rows(X, device) -> torch.Tensor:
    """Raw vectors (array or tensor) as a float32 tensor on ``device``."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.array(X, dtype=np.float32))
    return X.to(device=device, dtype=torch.float32)


def _row_lists(offsets: np.ndarray, capacity: int,
               num_lists: int) -> np.ndarray:
    """Coarse list of every CSR row (sentinel and reserve rows clamp into
    the last list; they are holes, so the value never matters)."""
    rl = np.searchsorted(offsets, np.arange(capacity), side="right") - 1
    return np.clip(rl, 0, num_lists - 1).astype(np.int32)


def _repack_bound(live: int, num_lists: int, block_size: int) -> int:
    """Upper bound on ``pack()``'s capacity for ``live`` rows however they
    spread over the lists: rounding wastes under one block a list, plus the
    sentinel block; a block multiple by construction."""
    bound = live + num_lists * (block_size - 1) + block_size
    return math.ceil(bound / block_size) * block_size


def _buffers(stg) -> tuple:
    """The staging buffers of a state: one, or one a shard."""
    if stg is None:
        return ()
    return stg if isinstance(stg, tuple) else (stg,)


def _replace_shards(state, codes=None, ids=None, offsets=None):
    """A sharded ADC state with new per-shard CSR tensors (S-tuples; None
    keeps a field); the shared components stay."""
    parts = []
    for s, p in enumerate(state.shards):
        upd = {}
        if codes is not None:
            upd["codes"] = codes[s]
        if ids is not None:
            upd["ids"] = ids[s]
        if offsets is not None:
            upd["list_offsets"] = offsets[s]
        parts.append(dataclasses.replace(p, **upd))
    return dataclasses.replace(state, shards=tuple(parts))


# ---------------------------------------------------------------------------
# Occupancy facts (host-side, for controllers and tests)
# ---------------------------------------------------------------------------


def staged_rows(state) -> int:
    """Live rows staged, over every shard (0 without a buffer)."""
    return sum(int(torch.sum(b.ids >= 0))
               for b in _buffers(getattr(state, "staging", None)))


def free_slots(state) -> int:
    """Free staging slots, over every shard (0 without a buffer)."""
    return sum(int(torch.sum(b.ids < 0))
               for b in _buffers(getattr(state, "staging", None)))


def staging_capacity(state) -> int:
    """Staging slots, over every shard (0 without a buffer)."""
    return sum(b.capacity for b in _buffers(getattr(state, "staging", None)))


def shard_rows(state) -> list[int]:
    """Live rows of each shard of a sharded ADC state, staged included."""
    stg = state.staging or (None,) * state.num_shards
    return [int(torch.sum(i >= 0)) + (0 if b is None else
                                      int(torch.sum(b.ids >= 0)))
            for i, b in zip(state.ids, stg)]


def live_rows(state) -> int:
    """Servable rows: CSR or corpus rows plus staged ones."""
    kind = _kind(state)
    if kind == "index":
        return int(torch.sum(state.ids >= 0))
    if kind == "adc":
        return int(torch.sum(state.index.ids >= 0)) + staged_rows(state)
    if kind == "exact_stream":
        return sum(int(torch.sum(t >= 0)) for t in state.tile_ids)
    if kind.startswith("sharded"):
        return sum(int(torch.sum(t >= 0)) for t in state.ids) \
            + staged_rows(state)
    return int(torch.sum(state.ids >= 0))


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


def with_staging(state, capacity: int, *, window_slack: int | None = None):
    """Attach an empty append buffer of ``capacity`` rows. Do it once,
    before the first search, so the Engine's executables serve staged rows
    from their first use on.

    ``window_slack`` blocks are added to the probe window ``max_blocks``
    (default: the buffer's capacity in blocks), so a list that grows when
    staged rows are compacted in stays fully scanned at the same schedule
    shape; out-of-range window tiles read the sentinel hole block, so the
    slack costs masked scan work only.

    The CSR also gains block-rounding headroom (up to a block a list, holes
    past the last list, never scanned or flushed into): a ``compact()`` of
    the same live rows may round each list's padding differently, and the
    reserve keeps that drift from growing the tensors."""
    kind = _kind(state)
    if kind == "sharded_adc":
        return _with_staging_sharded(state, capacity, window_slack)
    if kind != "adc":
        raise TypeError(
            "append buffers require a quantized (ADC) state — exact "
            "backends store raw vectors and take no staged codes")
    if state.staging is not None:
        return state
    idx = state.index
    slack = (math.ceil(capacity / idx.block_size) if window_slack is None
             else window_slack)
    buf = churn_buffer.empty(capacity, idx.codes.shape[1], idx.codes.dtype,
                             device=idx.device)
    idx = _pad_capacity(idx, _repack_bound(idx.num_items(), idx.num_lists,
                                           idx.block_size))
    return dataclasses.replace(state, index=idx, staging=buf,
                               max_blocks=state.max_blocks + slack)


def _with_staging_sharded(state, capacity: int, window_slack):
    """``with_staging`` on a sharded state: one buffer of ``capacity``
    rows a shard, on its device, and every shard's CSR padded to the
    reserve of its fullest shard (the CSRs keep one capacity)."""
    if state.staging is not None:
        return state
    bs = state.block_size
    slack = math.ceil(capacity / bs) if window_slack is None else window_slack
    mb = state.max_blocks
    if mb < 1:
        mb = max(p.max_list_blocks() for p in state.shards)
    live = max(int(torch.sum(i >= 0)) for i in state.ids)
    cap = max(state.capacity, _repack_bound(live, state.num_lists, bs))
    bufs = tuple(churn_buffer.empty(capacity, p.codes.shape[1],
                                    p.codes.dtype, device=p.device)
                 for p in state.shards)
    padded = [_pad_capacity(p, cap) for p in state.shards]
    out = _replace_shards(state, codes=[p.codes for p in padded],
                          ids=[p.ids for p in padded])
    return dataclasses.replace(out, staging=bufs, max_blocks=mb + slack)


def stage(state, X_new, new_ids):
    """Encode raw rows against the state's quantizers and park them in the
    lowest free staging slots. Raises ``ValueError`` when the buffer cannot
    hold them (``flush``/``compact`` first; the controller does).

    The encode uses the state's stored rotation: the frozen R₀ under fused
    refresh, like the frozen codebooks the CSR codes live in, so staged and
    resident rows score through one LUT pack."""
    kind = _kind(state)
    stg = getattr(state, "staging", None)
    if stg is None:
        raise ValueError(
            "state has no staging buffer — churn.with_staging(state, cap) "
            "first (before the first search)")
    if kind == "sharded_adc":
        return _stage_sharded(state, X_new, new_ids)
    if kind != "adc":
        raise TypeError("stage() needs a quantized state with a staging "
                        "buffer")
    idx = state.index
    new_ids = _as_ids(new_ids, idx.device)
    m = int(new_ids.shape[0])
    free = torch.nonzero(stg.ids < 0).squeeze(1)
    if free.numel() < m:
        raise ValueError(
            f"staging buffer full: {m} new rows, {free.numel()} free slots "
            "— flush() or compact() first")
    XR = _as_rows(X_new, idx.device) @ idx.R
    list_ids, codes = index_ivf.encode(XR, idx.coarse, idx.quantizer)
    sl = free[:m]
    s_codes, s_ids, s_lists = stg.codes.clone(), stg.ids.clone(), \
        stg.lists.clone()
    s_codes[sl] = codes.to(s_codes.dtype)
    s_ids[sl] = new_ids
    s_lists[sl] = list_ids
    return dataclasses.replace(state, staging=StagingBuffer(
        codes=s_codes, ids=s_ids, lists=s_lists))


def _stage_sharded(state, X_new, new_ids):
    """``stage`` on a sharded state: the rows are encoded on the head
    device, and each in turn goes to the lowest free slot of the shard
    with the most free slots (the first such shard on a tie), so the side
    passes stay balanced."""
    head = state.R.device
    new_ids = _as_ids(new_ids, "cpu")
    m = int(new_ids.shape[0])
    free = [list(np.nonzero(b.ids.cpu().numpy() < 0)[0])
            for b in state.staging]
    if sum(len(f) for f in free) < m:
        raise ValueError(
            f"staging buffers full: {m} new rows, "
            f"{sum(len(f) for f in free)} free slots across shards — "
            "flush() or compact() first")
    XR = _as_rows(X_new, head) @ state.R
    list_ids, codes = index_ivf.encode(XR, state.coarse, state.quantizer)
    rows_of = [[] for _ in free]
    slots_of = [[] for _ in free]
    for r in range(m):
        s = max(range(len(free)), key=lambda j: len(free[j]))
        slots_of[s].append(free[s].pop(0))
        rows_of[s].append(r)
    bufs = []
    for b, rows, slots in zip(state.staging, rows_of, slots_of):
        if not rows:
            bufs.append(b)
            continue
        dev = b.ids.device
        r = torch.as_tensor(rows, dtype=torch.long)
        sl = torch.as_tensor(slots, dtype=torch.long, device=dev)
        s_codes, s_ids, s_lists = b.codes.clone(), b.ids.clone(), \
            b.lists.clone()
        s_codes[sl] = codes[r.to(head)].to(dev, s_codes.dtype)
        s_ids[sl] = new_ids[r].to(dev)
        s_lists[sl] = list_ids[r.to(head)].to(dev)
        bufs.append(StagingBuffer(codes=s_codes, ids=s_ids, lists=s_lists))
    return dataclasses.replace(state, staging=tuple(bufs))


def _flush_plan(ids: np.ndarray, offsets: np.ndarray, s_ids: np.ndarray,
                s_lists: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(holes, slots): the CSR hole rows and the staged slots that fill
    them. Within each list the lowest holes take the lowest staged slots,
    as many as fit; the sentinel and reserve rows past ``offsets[-1]`` are
    never targets (the JAX package's ``_flush_into``, list by list, done for
    all lists at once)."""
    staged = np.nonzero(s_ids >= 0)[0]
    num_lists = offsets.shape[0] - 1
    holes = np.nonzero(ids[:int(offsets[-1])] < 0)[0]
    if not staged.size or not holes.size:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    hole_list = np.searchsorted(offsets, holes, side="right") - 1
    first_hole = np.searchsorted(hole_list, np.arange(num_lists))
    holes_of = np.bincount(hole_list, minlength=num_lists)
    staged = staged[np.argsort(s_lists[staged], kind="stable")]
    lists = s_lists[staged].astype(np.int64)
    rank = np.arange(staged.size) - np.searchsorted(lists, lists)
    fit = rank < holes_of[lists]
    return holes[first_hole[lists[fit]] + rank[fit]], staged[fit]


def flush(state):
    """Fold staged rows into the CSR's holes, offsets and shapes untouched.
    Rows whose list has no hole stay staged (``compact`` takes them).
    Returns ``(new_state, rows_moved)``."""
    kind = _kind(state)
    stg = getattr(state, "staging", None)
    if stg is None:
        return state, 0
    if kind == "sharded_adc":
        # each shard flushes into its own CSR
        moved, codes, ids, bufs = 0, [], [], []
        for p, b in zip(state.shards, stg):
            p, b, n = _flush_one(p, b)
            moved += n
            codes.append(p.codes)
            ids.append(p.ids)
            bufs.append(b)
        if not moved:
            return state, 0
        return dataclasses.replace(_replace_shards(
            state, codes=codes, ids=ids), staging=tuple(bufs)), moved
    if kind != "adc":
        raise TypeError("flush() needs a quantized state with a staging "
                        "buffer")
    idx, stg, moved = _flush_one(state.index, stg)
    if not moved:
        return state, 0
    return dataclasses.replace(state, index=idx, staging=stg), moved


def _flush_one(idx: IVFPQIndex, stg: StagingBuffer):
    """Flush one buffer into one CSR -> (index, buffer, rows moved); the
    inputs themselves when nothing moves."""
    holes, slots = _flush_plan(idx.ids.cpu().numpy(),
                               idx.list_offsets.cpu().numpy(),
                               stg.ids.cpu().numpy(), stg.lists.cpu().numpy())
    if not holes.size:
        return idx, stg, 0
    h = torch.from_numpy(holes).to(idx.device)
    s = torch.from_numpy(slots).to(idx.device)
    ids, codes, s_ids = idx.ids.clone(), idx.codes.clone(), stg.ids.clone()
    ids[h] = stg.ids[s]
    codes[h] = stg.codes[s]
    s_ids[s] = -1
    return (dataclasses.replace(idx, codes=codes, ids=ids),
            dataclasses.replace(stg, ids=s_ids), int(holes.size))


# ---------------------------------------------------------------------------
# Tombstones
# ---------------------------------------------------------------------------


def _tombstone_ids(ids: torch.Tensor, rids: torch.Tensor) -> torch.Tensor:
    """A new id tensor with every id in ``rids`` flipped to −1."""
    rids = rids.to(device=ids.device, dtype=ids.dtype)
    return torch.where(torch.isin(ids, rids), torch.full_like(ids, -1), ids)


def tombstone_index(index: IVFPQIndex, remove_ids) -> IVFPQIndex:
    """Tombstone items of a bare index by id: their rows become holes
    (id −1) that score −inf in the scans and take later flushes. Keeps
    every shape."""
    return dataclasses.replace(index, ids=_tombstone_ids(
        index.ids, _as_ids(remove_ids, index.device)))


def tombstone(state, remove_ids):
    """O(1) delete on any state: matching ids, resident and staged, flip
    to −1 (on every shard of a sharded state). Nothing is reshaped; the
    rows stop scoring on the next query."""
    kind = _kind(state)
    if kind == "sharded_adc":
        rids = _as_ids(remove_ids, "cpu")
        stg = state.staging
        if stg is not None:
            stg = tuple(dataclasses.replace(b, ids=_tombstone_ids(b.ids,
                                                                  rids))
                        for b in stg)
        return dataclasses.replace(_replace_shards(
            state, ids=[_tombstone_ids(i, rids) for i in state.ids]),
            staging=stg)
    if kind == "sharded_exact":
        rids = _as_ids(remove_ids, "cpu")
        return dataclasses.replace(state, ids=tuple(
            _tombstone_ids(i, rids) for i in state.ids))
    if kind == "index":
        return tombstone_index(state, remove_ids)
    if kind == "adc":
        rids = _as_ids(remove_ids, state.index.device)
        stg = state.staging
        if stg is not None:
            stg = dataclasses.replace(stg, ids=_tombstone_ids(stg.ids, rids))
        return dataclasses.replace(
            state, index=tombstone_index(state.index, rids), staging=stg)
    if kind == "exact":
        return dataclasses.replace(state, ids=_tombstone_ids(
            state.ids, _as_ids(remove_ids, state.ids.device)))
    # exact_stream: host tile id tensors and a live-row count
    rids = _as_ids(remove_ids, "cpu")
    tile_ids = tuple(_tombstone_ids(t, rids) for t in state.tile_ids)
    rows = sum(int(torch.sum(t >= 0)) for t in tile_ids)
    return dataclasses.replace(state, tile_ids=tile_ids, rows=rows)


# ---------------------------------------------------------------------------
# Compaction
# ---------------------------------------------------------------------------


def _pad_capacity(index: IVFPQIndex, cap: int) -> IVFPQIndex:
    """Append hole rows up to ``cap`` rows. Both capacities are block
    multiples, so the last block stays all holes and ``sentinel_block``
    stays a valid redirect target."""
    extra = cap - index.capacity
    if extra <= 0:
        return index
    codes = torch.cat([index.codes, index.codes.new_zeros(
        (extra, index.codes.shape[1]))])
    ids = torch.cat([index.ids, index.ids.new_full((extra,), -1)])
    return dataclasses.replace(index, codes=codes, ids=ids)


def _gather_live(index: IVFPQIndex):
    """(codes, list_ids, ids) of the live CSR rows, as host arrays: the
    operands of ``pack()``."""
    ids = index.ids.cpu().numpy()
    live = ids >= 0
    rl = _row_lists(index.list_offsets.cpu().numpy(), ids.shape[0],
                    index.num_lists)
    return index.codes.cpu().numpy()[live], rl[live], ids[live]


def _drain_staged(stg: StagingBuffer):
    """(codes, list_ids, ids) of the live staged rows, as host arrays."""
    s_ids = stg.ids.cpu().numpy()
    live = s_ids >= 0
    return (stg.codes.cpu().numpy()[live],
            stg.lists.cpu().numpy()[live].astype(np.int32), s_ids[live])


def _empty_like(stg: StagingBuffer) -> StagingBuffer:
    return dataclasses.replace(stg, ids=torch.full_like(stg.ids, -1))


def _reencode_rows(codes: np.ndarray, lists: np.ndarray, ids: np.ndarray,
                   reencode, R: torch.Tensor, coarse, quantizer):
    """Re-encode the gathered rows named by ``reencode=(ids, vectors)``
    against the state's rotation and quantizers (the staleness pass).
    ``vectors`` are the raw embeddings in the order of the id list; ids not
    live in this gather are skipped. Returns (codes, lists, rows
    re-encoded), on copies. The encode runs on ``R``'s device."""
    rid = np.asarray(reencode[0]).astype(np.int64).reshape(-1)
    if rid.size == 0 or ids.size == 0:
        return codes, lists, 0
    order = np.argsort(ids, kind="stable")
    at = np.minimum(np.searchsorted(ids, rid, sorter=order), ids.size - 1)
    keep = np.nonzero(ids[order[at]] == rid)[0]
    if keep.size == 0:
        return codes, lists, 0
    sel = order[at[keep]]
    vectors = reencode[1]
    if isinstance(vectors, torch.Tensor):
        rows = vectors[torch.from_numpy(keep).to(vectors.device)]
    else:
        rows = np.asarray(vectors)[keep]
    XR = _as_rows(rows, R.device) @ R
    new_lists, new_codes = index_ivf.encode(XR, coarse, quantizer)
    codes = codes.copy()
    lists = lists.copy()
    codes[sel] = new_codes.cpu().numpy()
    lists[sel] = new_lists.cpu().numpy()
    return codes, lists, int(keep.size)


def _repack(idx: IVFPQIndex, c, l, i) -> IVFPQIndex:
    return index_ivf.pack(idx.R, idx.coarse, idx.quantizer,
                          torch.from_numpy(c), torch.from_numpy(l),
                          torch.from_numpy(i), block_size=idx.block_size)


def compact(state, *, include_staged: bool = True, reencode=None):
    """Reclaim tombstoned blocks: repack the live rows (and drain the
    staging buffer, by default) into a fresh block-aligned CSR. Codes are
    carried, never re-encoded, so the scores equal a fresh pack of the same
    rows under the same quantizers.

    ``reencode=(ids, vectors)`` folds a staleness pass into the repack:
    those live rows are re-encoded from their raw vectors against the
    state's rotation and quantizers, and re-homed to their new list.

    The capacity is padded back to the old one whenever the live rows fit
    (balanced churn: the same shapes); a grown corpus returns larger
    tensors, and a list grown past the probe window raises ``max_blocks``;
    the controller counts both as grows."""
    kind = _kind(state)
    if kind == "sharded_adc":
        return _compact_sharded(state, include_staged=include_staged,
                                rebalance=False, reencode=reencode)
    if kind == "index":
        c, l, i = _gather_live(state)
        if reencode is not None:
            c, l, _ = _reencode_rows(c, l, i, reencode, state.R,
                                     state.coarse, state.quantizer)
        return _pad_capacity(_repack(state, c, l, i), state.capacity)
    if kind != "adc":
        raise TypeError("compact() needs a quantized (ADC or index) state")
    idx = state.index
    parts = [_gather_live(idx)]
    stg = state.staging
    if include_staged and stg is not None:
        parts.append(_drain_staged(stg))
        stg = _empty_like(stg)
    c, l, i = (np.concatenate([p[j] for p in parts]) for j in range(3))
    if reencode is not None:
        c, l, _ = _reencode_rows(c, l, i, reencode, idx.R, idx.coarse,
                                 idx.quantizer)
    new = _pad_capacity(_repack(idx, c, l, i), idx.capacity)
    return dataclasses.replace(
        state, index=new, staging=stg,
        max_blocks=max(state.max_blocks, new.max_list_blocks()))


def shard_rebalance(state, *, include_staged: bool = True):
    """Move rows between shards whose occupancy drifted apart: gather every
    live (and staged) row, re-partition by id rank (``ivf.shard_split``'s
    rule), repack each shard. Codes are carried, so the scores are a fresh
    repack's; the capacity is padded back to the common one when the rows
    fit, so a steady-state rebalance keeps every shape. Tombstoned rows
    are reclaimed on the way."""
    if _kind(state) != "sharded_adc":
        raise TypeError("shard_rebalance() needs a sharded ADC state")
    return _compact_sharded(state, include_staged=include_staged,
                            rebalance=True)


def _compact_sharded(state, *, include_staged: bool, rebalance: bool,
                     reencode=None):
    """Per-shard repack (compact), or a global id-rank re-partition and a
    per-shard repack (rebalance). The plan runs on host copies of each
    shard's live rows; each shard's pack lands on its device."""
    stg = state.staging if include_staged else None
    per_shard = []
    for s, p in enumerate(state.shards):
        parts = [_gather_live(p)]
        if stg is not None:
            parts.append(_drain_staged(stg[s]))
        c, l, i = (np.concatenate([q[j] for q in parts]) for j in range(3))
        if reencode is not None:
            c, l, _ = _reencode_rows(c, l, i, reencode, state.R,
                                     state.coarse, state.quantizer)
        per_shard.append((c, l, i))
    if rebalance:
        all_c, all_l, all_i = (np.concatenate([q[j] for q in per_shard])
                               for j in range(3))
        rank = np.empty(all_i.size, dtype=np.int64)
        rank[np.argsort(all_i, kind="stable")] = np.arange(all_i.size)
        shard_of = (rank * state.num_shards) // max(all_i.size, 1)
        per_shard = [(all_c[shard_of == s], all_l[shard_of == s],
                      all_i[shard_of == s])
                     for s in range(state.num_shards)]
    packed = [_repack(p, c, l, i)
              for p, (c, l, i) in zip(state.shards, per_shard)]
    cap = max(max(q.capacity for q in packed), state.capacity)
    packed = [_pad_capacity(q, cap) for q in packed]
    mb = state.max_blocks
    if mb >= 1:
        mb = max(mb, max(q.max_list_blocks() for q in packed))
    out = _replace_shards(state, codes=[q.codes for q in packed],
                          ids=[q.ids for q in packed],
                          offsets=[q.list_offsets for q in packed])
    staging = state.staging
    if stg is not None:
        staging = tuple(_empty_like(b) for b in stg)
    return dataclasses.replace(out, staging=staging, max_blocks=mb)


# ---------------------------------------------------------------------------
# Bare-index ingest (the maintain.add path)
# ---------------------------------------------------------------------------


def ingest_index(index: IVFPQIndex, X_new, new_ids) -> IVFPQIndex:
    """Eager insert into a bare index: encode against its centroids and
    codebooks, fill each target list's holes, and repack everything on the
    host when a list overflows (as ``ivf.build`` does). The one-shot,
    offline path; live serving stages and flushes instead."""
    XR = _as_rows(X_new, index.device) @ index.R
    list_ids, codes_new = index_ivf.encode(XR, index.coarse, index.quantizer)
    list_ids_np = list_ids.cpu().numpy()
    new_ids_np = _as_ids(new_ids, "cpu").numpy()
    ids_np = index.ids.cpu().numpy().copy()
    all_codes_np = index.codes.cpu().numpy().copy()
    codes_np = codes_new.cpu().numpy().astype(all_codes_np.dtype)
    offsets = index.list_offsets.cpu().numpy()

    overflow = []
    for l in np.unique(list_ids_np):
        take = np.nonzero(list_ids_np == l)[0]
        seg = slice(int(offsets[l]), int(offsets[l + 1]))
        holes = np.nonzero(ids_np[seg] < 0)[0] + offsets[l]
        fit = min(len(holes), len(take))
        ids_np[holes[:fit]] = new_ids_np[take[:fit]]
        all_codes_np[holes[:fit]] = codes_np[take[:fit]]
        overflow.extend(take[fit:].tolist())

    dev = index.device
    if not overflow:
        return dataclasses.replace(
            index, codes=torch.from_numpy(all_codes_np).to(dev),
            ids=torch.from_numpy(ids_np).to(dev))
    # a list overflowed its padding: repack everything (live rows keep
    # their codes; only the layout is rebuilt)
    live = ids_np >= 0
    row_list = _row_lists(offsets, len(ids_np), index.num_lists)
    ov = np.asarray(overflow)
    return _repack(index,
                   np.concatenate([all_codes_np[live], codes_np[ov]]),
                   np.concatenate([row_list[live], list_ids_np[ov]]),
                   np.concatenate([ids_np[live], new_ids_np[ov]]))
