"""The port's live churn (``repro_torch.churn``, the staging side pass in
``search.flat``/``search.ivf``, ``index.maintain``'s shims and subspace
step, the Engine's churn block, ``bench.churn``) on the CPU.

Two kinds of test. The single-device tests of ``tests/test_churn.py``,
ported to the port's own states (the index is the JAX package's, carried
across by ``convert``): staged adds served by the next query, flush and
compaction keeping every score, interleaved mutations against a fresh pack
of the live rows, the controller's steady state, the background compactor
and the staleness pass. And parity tests: the same numpy corpus and the
same adds and removes through the JAX ``churn.ops`` and the port's, on
dyadic inputs (a rotation of ±1 entries, centroids, codebooks and vectors
on a grid of 1/4), where every distance is exact in float32, so both
packages must choose the same lists and codes: ids, list offsets, codes
and the staging buffer equal after every step; the side pass's scores
within 1e-5; the Engine's churn counters equal.

``test_controller_zero_executables_in_steady_state`` is the port's
counterpart of the JAX ``test_controller_zero_recompiles_in_steady_state``
(which fails on the JAX package: at ``compact_at = 0.1`` its 120 deletes
stay under the threshold of its 1,264-row CSR, so no compaction fires).
The port has no trace cache: the test holds no new Engine executable, no
LUT invalidation, and every tensor shape of the state and ``max_blocks``
unchanged through the churn, at ``compact_at = 0.05``, where a compaction
fires; ``test_engine_churn_stats_match_jax`` holds the JAX test's own
thresholds, where both packages count no compaction.

The sharded branches run here on CPU shards in one test; their parity
with the JAX package is in ``tests/test_torch_sharded.py``.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro import churn as jchurn
from repro import quant as jquant
from repro import rotations as jrot
from repro import search as jsearch
from repro.data import synthetic as jsynth
from repro.index import ivf as jivf
from repro.index import maintain as jmaintain
from repro_torch import churn, convert, rotations, search
from repro_torch.bench import churn as bench
from repro_torch.index import ivf as index_ivf
from repro_torch.index import maintain
from repro_torch.index import search as index_search
from repro_torch.launch import mesh as launch_mesh

DIM, SUB, K, L, BS = 16, 4, 16, 8, 8
N, B = 1200, 8
CFG = dict(num_lists=L, subspaces=SUB, codewords=K, block_size=BS, nprobe=L,
           tile_rows=256)
SCORE_ATOL = 1e-5          # the side pass's scores against the JAX package's


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _index_arrays(index) -> dict:
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size)


@pytest.fixture(scope="module")
def data():
    """The JAX test's corpus, rotation and queries as numpy, the JAX index
    built on them, and the port's copy of that index."""
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), N, DIM))
    R = np.asarray(jrot.random_rotation(jax.random.PRNGKey(1), DIM))
    Q = np.asarray(jsynth.sift_like(jax.random.PRNGKey(2), B, DIM))
    jindex = jivf.build(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(R),
                        jsearch.SearchConfig(**CFG).ivf_config(),
                        train_size=512)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    return X, R, Q, tindex


def _fresh_ivf(data, **attach_kw):
    return search.IVF.attach(data[3], nprobe=L, **attach_kw)


def _delta(R, key: int = 0, lr: float = 1e-3):
    """A subspace-GCD delta on a seeded Gaussian gradient."""
    G = torch.from_numpy(np.random.RandomState(100 + key).randn(
        DIM, DIM).astype(np.float32))
    learner = rotations.make("subspace_gcd", sub=DIM // SUB)
    R = R if isinstance(R, torch.Tensor) else torch.from_numpy(np.array(R))
    _, delta = learner.update(learner.init_from(R), G, lr)
    return delta


def _rows(seed: int, m: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, DIM)).astype(
        np.float32)


def _result_map(res):
    """Per-query {id: score}: a comparison that ignores packing order."""
    ids, scores = res.ids.numpy(), res.scores.numpy()
    return [{int(i): float(s) for i, s in zip(ri, rs) if i >= 0}
            for ri, rs in zip(ids, scores)]


def _assert_same_results(a, b, rtol=1e-5):
    for da, db in zip(_result_map(a), _result_map(b)):
        assert set(da) == set(db)
        for i in da:
            np.testing.assert_allclose(da[i], db[i], rtol=rtol, atol=1e-5)


def _ivf_search(state, Q, k=10):
    return search.make("ivf").search(state, _t(Q), k=k,
                                     nprobe=L)


# ---------------------------------------------------------------------------
# Staging buffer: adds visible to the next query, flush/compact exact
# ---------------------------------------------------------------------------


def test_staged_adds_served_immediately(data):
    X, R, Q, _ = data
    state = churn.with_staging(_fresh_ivf(data), 64)
    Xn = np.asarray(jsynth.sift_like(jax.random.PRNGKey(7), 20, DIM))
    state = churn.stage(state, Xn, np.arange(N, N + 20))
    assert churn.staged_rows(state) == 20
    # the side pass serves what an eager insert into the CSR serves
    res = _ivf_search(state, Xn, k=5)
    eager = search.IVF.attach(
        churn.ingest_index(state.index, Xn, np.arange(N, N + 20)), nprobe=L)
    _assert_same_results(res, _ivf_search(eager, Xn, k=5))
    res10 = _ivf_search(state, Xn)
    want10 = _ivf_search(eager, Xn)
    hits = [N + i in res10.ids[i].tolist() for i in range(20)]
    want_hits = [N + i in want10.ids[i].tolist() for i in range(20)]
    assert hits == want_hits
    # flat_adc serves the same staged rows through the same state
    res_flat = search.make("flat_adc").search(state, _t(Xn), k=5)
    _assert_same_results(res, res_flat)
    # flush folds them into CSR holes without moving any score
    before = _ivf_search(state, Q)
    state2, moved = churn.flush(state)
    assert moved + churn.staged_rows(state2) == 20
    _assert_same_results(before, _ivf_search(state2, Q))


def test_staged_rows_score_as_flushed_rows_bit_for_bit(data):
    """The side pass adds the coarse term in the main scan's fixed-shape
    chunks and sums the codes in the main scan's order, so a staged row
    scores exactly as it does once flushed into the CSR."""
    X = data[0]
    Xn = X[:16] + 0.5
    state = churn.stage(churn.with_staging(_fresh_ivf(data), 64), Xn,
                        np.arange(N, N + 16))
    flushed, moved = churn.flush(state)
    assert moved > 0
    a, b = _ivf_search(state, Xn), _ivf_search(flushed, Xn)
    assert bool(torch.isin(torch.arange(N, N + 16), a.ids).any())
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


def test_with_staging_rejects_exact_states(data):
    X, R, _, _ = data
    ex = search.make("exact").build(None, _t(X),
                                    _t(R),
                                    search.SearchConfig(**CFG), device="cpu")
    with pytest.raises(TypeError, match="append buffers"):
        churn.with_staging(ex, 64)


def test_stage_overflow_raises(data):
    state = churn.with_staging(_fresh_ivf(data), 8)
    Xn = _rows(8, 9)
    with pytest.raises(ValueError, match="staging buffer full"):
        churn.stage(state, Xn, np.arange(N, N + 9))
    with pytest.raises(ValueError, match="no staging buffer"):
        churn.stage(_fresh_ivf(data), Xn[:1], np.array([N]))


def test_compact_is_bit_identical_to_fresh_rebuild(data):
    """compact() carries codes: a fresh pack of the same live rows under
    the same quantizers serves the same {id: score} sets."""
    X, R, Q, _ = data
    state = churn.with_staging(_fresh_ivf(data), 64)
    Xn = _rows(9, 30)
    state = churn.stage(state, Xn, np.arange(N, N + 30))
    state = churn.tombstone(state, np.arange(0, 300))
    before = _ivf_search(state, Q)
    compacted = churn.compact(state)
    assert churn.staged_rows(compacted) == 0
    after = _ivf_search(compacted, Q)
    _assert_same_results(before, after)
    assert compacted.index.capacity == state.index.capacity
    assert compacted.max_blocks == state.max_blocks

    idx = compacted.index
    live_X = torch.from_numpy(np.concatenate([X[300:], Xn]))
    live_ids = torch.from_numpy(np.concatenate(
        [np.arange(300, N), np.arange(N, N + 30)]).astype(np.int32))
    list_ids, codes = index_ivf.encode(live_X @ idx.R, idx.coarse,
                                       idx.quantizer)
    rebuilt = index_ivf.pack(idx.R, idx.coarse, idx.quantizer, codes,
                             list_ids, live_ids, block_size=BS)
    _assert_same_results(after, _ivf_search(
        search.IVF.attach(rebuilt, nprobe=L), Q))


def test_merge_orders_equal_scores_by_id(data):
    """A staged row and a resident row with equal scores: the merged top-k
    lists the smaller id first, whichever lane it came from. Two resident
    rows are copied into the buffer, one under a larger id and one under
    a smaller (freed) id; the queries are the copied rows themselves."""
    state = churn.with_staging(_fresh_ivf(data), 64)
    idx = state.index
    rows = torch.nonzero(idx.ids >= 0).squeeze(1)
    r_big, r_small = int(rows[0]), int(rows[1])
    state = churn.tombstone(state, [5])            # frees id 5
    buf = state.staging
    codes, ids, lists = buf.codes.clone(), buf.ids.clone(), buf.lists.clone()
    row_list = torch.searchsorted(idx.list_offsets, torch.tensor(
        [r_big, r_small], dtype=torch.int32), right=True) - 1
    pairs = ((r_big, int(idx.ids[r_big]) + 100000), (r_small, 5))
    for slot, ((row, new_id), lst) in enumerate(zip(pairs, row_list)):
        codes[slot], ids[slot], lists[slot] = idx.codes[row], new_id, lst
    state = dataclasses.replace(state, staging=churn.StagingBuffer(
        codes=codes, ids=ids, lists=lists))
    res = _ivf_search(state, data[0][[int(idx.ids[r_big]),
                                      int(idx.ids[r_small])]], k=N)
    for (row, new_id), s, i in zip(pairs, res.scores, res.ids):
        old = int(idx.ids[row])
        pos = {int(v): p for p, v in enumerate(i.tolist())}
        assert old in pos and new_id in pos
        assert s[pos[old]] == s[pos[new_id]]
        assert (pos[old] < pos[new_id]) == (old < new_id)
        fin = torch.isfinite(s)
        same = s[fin][:-1] == s[fin][1:]
        assert bool(torch.all(~same | (i[fin][:-1] < i[fin][1:])))


# ---------------------------------------------------------------------------
# Hypothesis: interleaved mutations vs a fresh pack of the live rows
# ---------------------------------------------------------------------------


@given(seq=st.lists(st.sampled_from(
    ["add", "remove", "refresh", "flush", "compact"]),
    min_size=1, max_size=7), seed=st.integers(0, 2**16))
@settings(deadline=None, max_examples=10, database=None, derandomize=True)
def test_interleaved_mutations_hold_parity(seq, seed):
    """Any interleaving of add/remove/refresh/flush/compact serves the same
    {id: score} sets as a fresh pack of its live rows under the state's
    current quantizers, and never returns a dead id."""
    rng = np.random.default_rng(seed)
    Xh = rng.standard_normal((400, DIM)).astype(np.float32)
    R = torch.from_numpy(np.linalg.qr(
        np.random.RandomState(1).randn(DIM, DIM))[0].astype(np.float32))
    Q = rng.standard_normal((4, DIM)).astype(np.float32)
    g = torch.Generator().manual_seed(3)
    index = index_ivf.build(g, torch.from_numpy(Xh), R,
                            search.SearchConfig(**CFG).ivf_config(),
                            train_size=256, device="cpu")
    searcher = search.make("ivf")
    state = churn.with_staging(search.IVF.attach(index, nprobe=L), 64)

    vecs = {i: Xh[i] for i in range(400)}
    next_id = 400
    for op in seq:
        if op == "add":
            m = int(rng.integers(1, 12))
            Xn = rng.standard_normal((m, DIM)).astype(np.float32)
            ids = np.arange(next_id, next_id + m)
            if churn.free_slots(state) < m:
                state = churn.compact(state)
            state = churn.stage(state, Xn, ids)
            vecs.update({int(i): x for i, x in zip(ids, Xn)})
            next_id += m
        elif op == "remove" and len(vecs) > 20:
            dead = rng.choice(sorted(vecs), size=10, replace=False)
            state = churn.tombstone(state, dead.astype(np.int32))
            for i in dead:
                vecs.pop(int(i))
        elif op == "refresh":
            state = searcher.refresh(state, _delta(R, key=len(vecs)))
        elif op == "flush":
            state, _ = churn.flush(state)
        elif op == "compact":
            state = churn.compact(state)

    got = _ivf_search(state, Q)
    ids = got.ids.numpy()
    assert set(ids[ids >= 0].ravel().tolist()) <= set(vecs)
    idx = state.index
    live_ids = np.asarray(sorted(vecs), dtype=np.int32)
    live_X = torch.from_numpy(np.stack([vecs[int(i)] for i in live_ids]))
    list_ids, codes = index_ivf.encode(live_X @ idx.R, idx.coarse,
                                       idx.quantizer)
    rebuilt = index_ivf.pack(idx.R, idx.coarse, idx.quantizer, codes,
                             list_ids, torch.from_numpy(live_ids),
                             block_size=BS)
    _assert_same_results(got, _ivf_search(
        search.IVF.attach(rebuilt, nprobe=L), Q), rtol=1e-4)


def _flush_reference(ids, offsets, s_codes, s_ids, s_lists, codes):
    """The JAX package's ``_flush_into``, list by list, on host copies."""
    ids, codes, s_ids = ids.copy(), codes.copy(), s_ids.copy()
    staged = np.nonzero(s_ids >= 0)[0]
    for lst in np.unique(s_lists[staged]) if staged.size else ():
        take = staged[s_lists[staged] == lst]
        seg = slice(int(offsets[lst]), int(offsets[lst + 1]))
        holes = np.nonzero(ids[seg] < 0)[0] + int(offsets[lst])
        fit = min(holes.size, take.size)
        ids[holes[:fit]] = s_ids[take[:fit]]
        codes[holes[:fit]] = s_codes[take[:fit]]
        s_ids[take[:fit]] = -1
    return ids, codes, s_ids


@given(seed=st.integers(0, 2**16), staged=st.integers(0, 40),
       dead=st.integers(0, 200))
@settings(deadline=None, max_examples=25, database=None, derandomize=True)
def test_flush_equals_the_list_by_list_reference(data, seed, staged, dead):
    """``ops.flush`` plans every list's moves at once; it moves the same
    rows into the same holes as the JAX package's list-by-list loop."""
    rng = np.random.default_rng(seed)
    state = churn.with_staging(_fresh_ivf(data), 64)
    state = churn.tombstone(state, rng.choice(N, size=dead, replace=False))
    if staged:
        state = churn.stage(state, _rows(seed, staged),
                            np.arange(N, N + staged))
    idx, stg = state.index, state.staging
    want = _flush_reference(idx.ids.numpy(), idx.list_offsets.numpy(),
                            stg.codes.numpy(), stg.ids.numpy(),
                            stg.lists.numpy(), idx.codes.numpy())
    got, moved = churn.flush(state)
    np.testing.assert_array_equal(got.index.ids.numpy(), want[0])
    np.testing.assert_array_equal(got.index.codes.numpy(), want[1])
    np.testing.assert_array_equal(got.staging.ids.numpy(), want[2])
    assert moved == int((stg.ids.numpy() >= 0).sum() - (want[2] >= 0).sum())


# ---------------------------------------------------------------------------
# ChurnController behind the Engine
# ---------------------------------------------------------------------------


def test_controller_zero_executables_in_steady_state(data):
    """Steady churn with training refreshes: no new executable, no LUT
    invalidation, every state tensor's shape and max_blocks unchanged from
    the first search on, no dead id served, every mutation exercised."""
    X, R, Q, _ = data
    engine = search.Engine(search.make("ivf"),
                           _fresh_ivf(data, fused_refresh=True), k=10,
                           nprobe=L, min_bucket=4)
    ctl = churn.ChurnController(engine, staging_rows=64, flush_at=0.5,
                                compact_at=0.05)
    Qt = _t(Q)
    engine.search(Qt)                    # the first search, with staging
    st0 = engine.stats()
    shapes0 = bench.state_shapes(engine.state)

    rng = np.random.default_rng(11)
    live = list(range(N))
    next_id = N
    for step in range(10):
        add = rng.standard_normal((12, DIM)).astype(np.float32)
        add_ids = np.arange(next_id, next_id + 12)
        next_id += 12
        dead = rng.choice(live, size=12, replace=False)
        live = [i for i in live if i not in set(dead.tolist())]
        live += add_ids.tolist()
        ctl.step(add=add, add_ids=add_ids, remove_ids=dead)
        engine.refresh(_delta(R, key=step))
        res = engine.search(Qt)
        ids = res.ids.numpy()
        assert set(ids[ids >= 0].ravel().tolist()) <= set(live)
        assert bench.state_shapes(engine.state) == shapes0

    st_ = engine.stats()
    assert st_["compiles"] == st0["compiles"]
    assert st_["executables"] == st0["executables"]
    assert st_["lut_invalidations"] == 0
    ch = st_["churn"]
    assert ch["staged"] == 120 and ch["tombstoned"] == 120
    assert ch["grows"] == 0
    assert ch["flushes"] >= 1 and ch["compactions"] >= 1
    assert ch["flush_ms_p95"] >= 0.0
    assert ch["window"]["capacity"] == engine.history
    # the side pass keeps the scan-work metric honest: staged rows counted
    assert int(res.scanned[0]) >= churn.staged_rows(ctl.state)


def test_controller_grows_when_corpus_grows(data):
    """Adds that outpace deletes past the capacity grow the CSR once, and
    the grow is counted."""
    _, _, Q, _ = data
    engine = search.Engine(search.make("ivf"), _fresh_ivf(data), k=10,
                           nprobe=L, min_bucket=4)
    ctl = churn.ChurnController(engine, staging_rows=32, flush_at=0.25,
                                compact_at=0.05)
    engine.search(_t(Q))
    rng = np.random.default_rng(12)
    next_id = N
    for _ in range(12):
        ctl.step(add=rng.standard_normal((24, DIM)).astype(np.float32),
                 add_ids=np.arange(next_id, next_id + 24))
        next_id += 24
    assert churn.live_rows(ctl.state) == N + 12 * 24
    assert engine.stats()["churn"]["grows"] >= 1


def test_engine_stats_churn_block_schema(data):
    """The churn block is always there, with the JAX Engine's keys, and
    all zero without a controller."""
    _, _, _, tindex = data
    engine = search.Engine(search.make("ivf"), _fresh_ivf(data), k=10,
                           nprobe=L)
    ch = engine.stats()["churn"]
    for key in ("staged", "flushed", "tombstoned", "flushes", "compactions",
                "rebalances", "grows"):
        assert ch[key] == 0
    assert ch["staged_rows"] == 0 and ch["tombstoned_rows"] == 0
    assert ch["window"]["scope"] == "flush_ms aggregates"
    jindex = jivf.IVFPQIndex(
        R=jnp.asarray(tindex.R.numpy()),
        coarse=jquant.VQ(centroids=jnp.asarray(tindex.centroids.numpy())),
        quantizer=jquant.PQ(codebooks=jnp.asarray(tindex.codebooks.numpy())),
        codes=jnp.asarray(tindex.codes.numpy()),
        ids=jnp.asarray(tindex.ids.numpy()),
        list_offsets=jnp.asarray(tindex.list_offsets.numpy()),
        block_size=BS)
    jengine = jsearch.Engine(jsearch.make("ivf"),
                             jsearch.IVF.attach(jindex, nprobe=L), k=10,
                             nprobe=L)
    assert set(ch) == set(jengine.stats()["churn"])


# ---------------------------------------------------------------------------
# maintain: the deprecated shims, the subspace step, the drift oracle
# ---------------------------------------------------------------------------


def test_maintain_shims_warn_and_match(data):
    index = _fresh_ivf(data).index
    Xn = _rows(13, 16)
    with pytest.warns(DeprecationWarning, match="churn.tombstone"):
        via_shim = maintain.remove(index, np.arange(50, dtype=np.int32))
    direct = churn.tombstone_index(index, np.arange(50, dtype=np.int32))
    assert torch.equal(via_shim.ids, direct.ids)
    new_ids = np.arange(N, N + 16, dtype=np.int32)
    with pytest.warns(DeprecationWarning, match="churn.ingest_index"):
        added = maintain.add(via_shim, Xn, new_ids)
    added_direct = churn.ingest_index(direct, Xn, new_ids)
    assert torch.equal(added.ids, added_direct.ids)
    assert torch.equal(added.codes, added_direct.codes)
    assert added.num_items() == N - 50 + 16


def test_subspace_gcd_step_matches_jax(data):
    """The same gradient gives both packages the same within-subspace
    pairs and angles, and the same refreshed rotation."""
    _, R, _, tindex = data
    G = np.random.RandomState(21).randn(DIM, DIM).astype(np.float32)
    jidx = jivf.IVFPQIndex(
        R=jnp.asarray(R),
        coarse=jquant.VQ(centroids=jnp.asarray(tindex.centroids.numpy())),
        quantizer=jquant.PQ(codebooks=jnp.asarray(tindex.codebooks.numpy())),
        codes=jnp.asarray(tindex.codes.numpy()),
        ids=jnp.asarray(tindex.ids.numpy()),
        list_offsets=jnp.asarray(tindex.list_offsets.numpy()),
        block_size=BS)
    jnew, (jpi, jpj, jth) = jmaintain.subspace_gcd_step(jidx, jnp.asarray(G),
                                                        1e-2)
    tnew, (pi, pj, th) = maintain.subspace_gcd_step(tindex, _t(G), 1e-2)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(pj.numpy(), np.asarray(jpj))
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-5,
                               atol=1e-8)
    assert bool(torch.all(pi // (DIM // SUB) == pj // (DIM // SUB)))
    np.testing.assert_allclose(tnew.R.numpy(), np.asarray(jnew.R), atol=1e-6)
    assert torch.equal(tnew.codes, tindex.codes)


def test_drifted_ids_matches_jax_and_empties_after_reencode(data):
    """Cross-subspace deltas drift stored codes off a fresh encode; the
    port's oracle names the JAX package's set on the same index."""
    X, R, _, tindex = data
    state = _fresh_ivf(data)
    learner = rotations.make("gcd_greedy")
    for t in range(3):
        G = _t(np.random.RandomState(t).randn(DIM, DIM).astype(np.float32))
        _, d = learner.update(learner.init_from(state.index.R), G, 5e-2)
        state = search.make("ivf").refresh(state, d)
    idx = state.index
    got = maintain.drifted_ids(idx, _t(X))
    jidx = jivf.IVFPQIndex(
        R=jnp.asarray(idx.R.numpy()),
        coarse=jquant.VQ(centroids=jnp.asarray(idx.centroids.numpy())),
        quantizer=jquant.PQ(codebooks=jnp.asarray(idx.codebooks.numpy())),
        codes=jnp.asarray(idx.codes.numpy()), ids=jnp.asarray(idx.ids.numpy()),
        list_offsets=jnp.asarray(idx.list_offsets.numpy()), block_size=BS)
    want = jmaintain.drifted_ids(jidx, jnp.asarray(X))
    assert got.size > 0
    # the two packages' float32 encodes may break a near tie differently
    assert len(set(got.tolist()) ^ set(want.tolist())) <= max(
        2, got.size // 20)


# ---------------------------------------------------------------------------
# Exact backends
# ---------------------------------------------------------------------------


def test_exact_tombstones_update_rows(data):
    X, R, Q, _ = data
    for name in ("exact_stream", "exact"):
        sr = search.make(name)
        state = sr.build(None, _t(X), _t(R),
                         search.SearchConfig(**CFG), device="cpu")
        before = churn.live_rows(state)
        state2 = churn.tombstone(state, np.arange(0, 200))
        assert churn.live_rows(state2) == before - 200
        if name == "exact_stream":
            assert state2.rows == state.rows - 200
        res = sr.search(state2, _t(Q), k=10)
        assert not np.any(np.isin(res.ids.numpy(), np.arange(200)))
        assert churn.live_rows(state) == before       # the input is kept


# ---------------------------------------------------------------------------
# Background compaction and the staleness pass
# ---------------------------------------------------------------------------


def test_background_compact_bit_identical_to_foreground(data):
    """A background pass that raced nothing equals a foreground
    ``churn.compact`` of the same snapshot, bit for bit."""
    _, _, Q, _ = data
    state = churn.with_staging(_fresh_ivf(data), 64)
    state = churn.tombstone(state, np.arange(0, N, 7, dtype=np.int32))
    eng = search.Engine(search.make("ivf"), state, k=10, nprobe=L)
    comp = churn.BackgroundCompactor(eng)
    fg = churn.compact(eng.state, include_staged=False)
    assert comp.submit()
    comp.join()
    assert comp.poll()
    assert torch.equal(eng.state.index.codes, fg.index.codes)
    assert torch.equal(eng.state.index.ids, fg.index.ids)
    res_bg, res_fg = _ivf_search(eng.state, Q), _ivf_search(fg, Q)
    assert torch.equal(res_bg.scores, res_fg.scores)
    assert torch.equal(res_bg.ids, res_fg.ids)
    comp.close()


def test_background_compactor_replays_mutations_since_submit(data):
    """Deletes and stages that land while the worker packs are kept:
    deletes replayed at the swap, staged rows from the current buffer."""
    X, _, Q, _ = data
    eng = search.Engine(search.make("ivf"),
                        churn.with_staging(_fresh_ivf(data), 64),
                        k=10, nprobe=L)
    comp = churn.BackgroundCompactor(eng, worker_delay_s=0.3)
    assert comp.submit()
    dead = np.arange(0, 40, dtype=np.int32)
    eng.state = churn.tombstone(eng.state, dead)
    eng.state = churn.stage(eng.state, X[:4],
                            np.asarray([N + 1, N + 2, N + 3, N + 4]))
    comp.join()
    assert comp.poll()
    assert eng.stats()["churn"]["bg_discarded"] == 0
    served = set(_ivf_search(eng.state, Q).ids.numpy().ravel().tolist())
    assert not served & set(dead.tolist())
    assert churn.staged_rows(eng.state) == 4
    assert not bool(torch.any(torch.isin(eng.state.index.ids,
                                         _t(dead))))
    comp.close()


def test_background_compactor_discards_on_csr_move(data):
    """A flush while the worker packs moves the CSR: the stale result is
    discarded at the poll, never swapped in."""
    X, _, _, _ = data
    eng = search.Engine(search.make("ivf"),
                        churn.with_staging(_fresh_ivf(data), 64),
                        k=10, nprobe=L)
    eng.state = churn.tombstone(eng.state, np.arange(0, 64, dtype=np.int32))
    eng.state = churn.stage(eng.state, X[:4],
                            np.asarray([N + 1, N + 2, N + 3, N + 4]))
    comp = churn.BackgroundCompactor(eng, worker_delay_s=0.3)
    assert comp.submit()
    eng.state, _ = churn.flush(eng.state)       # holes refilled: moved
    comp.join()
    assert not comp.poll()
    st_ = eng.stats()["churn"]
    assert st_["bg_discarded"] == 1 and st_["bg_compactions"] == 0
    comp.close()


def test_background_compactor_poll_stress_no_double_swap(data):
    """Racing pollers against a slow worker, over rounds: one swap per
    submit, one submit in flight at a time, stats readable throughout."""
    eng = search.Engine(search.make("ivf"),
                        churn.with_staging(_fresh_ivf(data), 64),
                        k=10, nprobe=L)
    comp = churn.BackgroundCompactor(eng, worker_delay_s=0.15)
    rounds = 3
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)       # more thread switches, more races
    try:
        _poll_rounds(eng, comp, rounds)
    finally:
        sys.setswitchinterval(switch)
    st_ = eng.stats()["churn"]
    assert st_["bg_compactions"] == rounds
    assert st_["bg_discarded"] == 0
    assert churn.live_rows(eng.state) == N - rounds * 20
    comp.close()


def _poll_rounds(eng, comp, rounds: int) -> None:
    for r in range(rounds):
        eng.state = churn.tombstone(
            eng.state, np.arange(r * 20, r * 20 + 20, dtype=np.int32))
        assert comp.submit()
        assert not comp.submit()
        swaps: list[int] = []
        stop = threading.Event()

        def poller():
            while not stop.is_set():
                if comp.poll():
                    swaps.append(1)
                eng.stats()
                time.sleep(0.002)

        threads = [threading.Thread(target=poller) for _ in range(4)]
        for t in threads:
            t.start()
        comp.join()
        deadline = time.time() + 10.0
        while not swaps and time.time() < deadline:
            time.sleep(0.005)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
        assert sum(swaps) == 1, swaps


def test_staleness_reencode_fixes_drifted_rows(data):
    """Cross-subspace deltas drift stored codes (``maintain.drifted_ids``);
    a compaction that re-encodes every stale row empties the drifted
    set."""
    X, _, _, _ = data
    eng = search.Engine(search.make("ivf"),
                        churn.with_staging(_fresh_ivf(data), 64),
                        k=10, nprobe=L)
    tracker = churn.StalenessTracker()
    tracker.record(np.arange(N))
    comp = churn.BackgroundCompactor(
        eng, tracker=tracker, reencode_fn=lambda ids: X[np.asarray(ids)],
        reencode_rows=N)
    learner = rotations.make("gcd_greedy")
    for t in range(4):
        G = _t(np.random.RandomState(t).randn(DIM, DIM).astype(np.float32))
        _, d = learner.update(learner.init_from(eng.state.index.R), G, 5e-2)
        eng.refresh(d)
        tracker.bump()
    Xt = _t(X)
    assert maintain.drifted_ids(eng.state.index, Xt).size > 0
    assert comp.submit()
    comp.join()
    assert comp.poll()
    assert maintain.drifted_ids(eng.state.index, Xt).size == 0
    assert eng.stats()["churn"]["reencoded"] == N
    assert tracker.stalest(N).size == 0
    comp.close()


def test_staleness_tracker_orders_by_epoch():
    tr = churn.StalenessTracker()
    tr.record([1, 2, 3])
    tr.bump()
    tr.record([4, 5])
    tr.bump()
    assert list(tr.stalest(2)) == [1, 2]
    assert list(tr.stalest(10)) == [1, 2, 3, 4, 5]
    tr.record([1, 2, 3, 4, 5])
    assert tr.stalest(10).size == 0
    tr.forget([5])
    assert len(tr) == 4
    assert {int(k) for k in tr.histogram()} == {0}


# ---------------------------------------------------------------------------
# Immutability, sharded states
# ---------------------------------------------------------------------------


def _tensors(state) -> dict:
    out = {f"index.{f}": getattr(state.index, f).clone()
           for f in ("codes", "ids", "list_offsets")}
    out.update({f"staging.{f}": getattr(state.staging, f).clone()
                for f in ("codes", "ids", "lists")})
    return out


def test_snapshot_is_unchanged_by_later_mutations(data):
    """A state taken before stage, tombstone, flush and compact reads the
    same bits after them: no primitive writes into a tensor another state
    can reach."""
    X, _, _, _ = data
    snap = churn.stage(churn.with_staging(_fresh_ivf(data), 64), X[:10] + 1,
                       np.arange(N, N + 10))
    kept = _tensors(snap)
    s = churn.stage(snap, X[10:20] + 1, np.arange(N + 10, N + 20))
    s = churn.tombstone(s, np.concatenate([np.arange(0, 100),
                                           [N + 1, N + 12]]))
    s, moved = churn.flush(s)
    assert moved > 0
    s = churn.compact(churn.stage(s, X[20:22] + 1, [N + 30, N + 31]))
    s = churn.compact(s, reencode=(np.arange(200, 260), X[200:260]))
    for name, t in _tensors(snap).items():
        assert torch.equal(t, kept[name]), name


def test_sharded_branches_raise_and_name_item_11(data):
    """The sharded branches are ported (tests/test_torch_sharded.py holds
    them to the JAX package): every primitive runs on a sharded state
    over two CPU shards and keeps the live set; ``shard_rebalance`` still
    refuses a single-device state; the churn bench's ``--devices`` cell
    runs and passes its four checks."""
    X, _, Q, tindex = data
    mesh = launch_mesh.make_data_mesh(devices=("cpu",) * 2)
    s = search.make("ivf_sharded", mesh=mesh)
    st = churn.with_staging(s.attach(tindex, mesh=mesh, nprobe=L), 8)
    st = churn.stage(st, X[:4], np.arange(N, N + 4))
    assert churn.staged_rows(st) == 4 and churn.live_rows(st) == N + 4
    st, moved = churn.flush(st)
    st = churn.tombstone(st, np.arange(0, 100))
    assert churn.live_rows(st) == N + 4 - 100
    before = s.search(st, torch.tensor(Q), k=10, nprobe=L)
    for op in (churn.compact, churn.shard_rebalance):
        st = op(st)
        after = s.search(st, torch.tensor(Q), k=10, nprobe=L)
        assert torch.equal(before.ids, after.ids)
        assert torch.equal(before.scores, after.scores)
    assert churn.live_rows(st) == N + 4 - 100
    fake_exact = search.make("exact_sharded", mesh=mesh).build(
        None, torch.from_numpy(X), torch.eye(DIM),
        search.SearchConfig(**CFG))
    assert churn.live_rows(churn.tombstone(fake_exact, [1])) == N - 1
    with pytest.raises(TypeError, match="sharded ADC state"):
        churn.shard_rebalance(_fresh_ivf(data))
    _, checks = bench.run(n=2000, dim=16, queries=16, lists=8, subspaces=4,
                          codewords=16, steps=3, batch=64, nprobe=8,
                          staging_rows=128, verbose=False, devices=2,
                          device="cpu", shard_device="cpu")
    assert all(checks[k] for k in (
        "sharded_zero_recompiles", "sharded_rebalanced",
        "sharded_no_tombstones", "sharded_recall_matches_repack"))


# ---------------------------------------------------------------------------
# Parity with the JAX package on dyadic inputs
# ---------------------------------------------------------------------------


def _dyadic():
    """An index whose every distance is exact in float32: R a signed
    permutation, centroids on a grid of 1/2, codebooks and vectors on a
    grid of 1/4. Returns (JAX index, port index, the add rows)."""
    rng = np.random.RandomState(5)
    R = np.eye(DIM, dtype=np.float32)[rng.permutation(DIM)] * np.where(
        rng.rand(DIM) < 0.5, -1.0, 1.0).astype(np.float32)[:, None]
    cent = (rng.randint(-4, 5, (L, DIM)) / 2).astype(np.float32)
    cb = (rng.randint(-4, 5, (SUB, K, DIM // SUB)) / 4).astype(np.float32)
    X = (rng.randint(-8, 9, (N, DIM)) / 4).astype(np.float32)
    adds = (rng.randint(-8, 9, (120, DIM)) / 4).astype(np.float32)
    coarse = jquant.VQ(centroids=jnp.asarray(cent))
    pq = jquant.PQ(codebooks=jnp.asarray(cb))
    lists, codes = jivf.encode(jnp.asarray(X) @ jnp.asarray(R), coarse, pq)
    jindex = jivf.pack(jnp.asarray(R), coarse, pq, codes, lists,
                       jnp.arange(N, dtype=jnp.int32), block_size=BS)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    return jindex, tindex, X, adds


def _assert_states_equal(t, j, what: str) -> None:
    for f in ("ids", "list_offsets", "codes"):
        np.testing.assert_array_equal(getattr(t.index, f).numpy(),
                                      np.asarray(getattr(j.index, f)),
                                      err_msg=f"{what}: index.{f}")
    for f in ("ids", "lists", "codes"):
        np.testing.assert_array_equal(getattr(t.staging, f).numpy(),
                                      np.asarray(getattr(j.staging, f)),
                                      err_msg=f"{what}: staging.{f}")
    assert t.max_blocks == j.max_blocks, what


@pytest.mark.parametrize("reencode", [False, True])
def test_mutations_match_jax_on_dyadic_inputs(reencode):
    """stage → flush → tombstone → stage → compact (and a compaction with a
    staleness re-encode) through both packages' ``churn.ops``: the CSR and
    the buffer equal after every step."""
    jindex, tindex, X, adds = _dyadic()
    j = jchurn.with_staging(jsearch.IVF.attach(jindex, nprobe=L), 64)
    t = churn.with_staging(search.IVF.attach(tindex, nprobe=L), 64)
    _assert_states_equal(t, j, "with_staging")
    steps = [
        ("stage", adds[:40], np.arange(N, N + 40)),
        ("flush",),
        ("tombstone", np.concatenate([np.arange(0, 600, 3), [N + 2, N + 5]])),
        ("stage", adds[40:70], np.arange(N + 40, N + 70)),
        ("compact",),
        ("stage", adds[70:90], np.arange(N + 70, N + 90)),
        ("tombstone", np.arange(600, 700)),
        ("flush",),
    ]
    if reencode:
        moved = (adds[90:120] + 0.25).astype(np.float32)
        steps.append(("compact", (np.arange(700, 730), moved)))
    for step in steps:
        if step[0] == "stage":
            j = jchurn.stage(j, jnp.asarray(step[1]),
                             step[2].astype(np.int32))
            t = churn.stage(t, step[1], step[2])
        elif step[0] == "flush":
            j, jm = jchurn.flush(j)
            t, tm = churn.flush(t)
            assert tm == jm
        elif step[0] == "tombstone":
            j = jchurn.tombstone(j, jnp.asarray(step[1], jnp.int32))
            t = churn.tombstone(t, step[1])
        else:
            re = step[1] if len(step) > 1 else None
            j = jchurn.compact(j, reencode=re)
            t = churn.compact(t, reencode=re)
        _assert_states_equal(t, j, str(step[0]))
        assert churn.live_rows(t) == jchurn.live_rows(j)
        assert churn.staged_rows(t) == jchurn.staged_rows(j)


def test_ingest_index_matches_jax_on_dyadic_inputs():
    """The eager insert, holes first, then a repack on overflow."""
    jindex, tindex, _, adds = _dyadic()
    for m in (8, 120):                     # fits in holes; overflows
        new_ids = np.arange(N, N + m, dtype=np.int32)
        j = jchurn.ingest_index(jindex, jnp.asarray(adds[:m]),
                                jnp.asarray(new_ids))
        t = churn.ingest_index(tindex, adds[:m], new_ids)
        for f in ("ids", "list_offsets", "codes"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
def test_staged_topk_matches_jax(lut_dtype):
    """The side pass on the same buffer, queries and LUT pack: ids equal,
    scores within SCORE_ATOL."""
    jindex, tindex, X, adds = _dyadic()
    j = jchurn.stage(jchurn.with_staging(jsearch.IVF.attach(
        jindex, nprobe=L), 64), jnp.asarray(adds[:50]),
        np.arange(N, N + 50, dtype=np.int32))
    j = jchurn.tombstone(j, jnp.asarray([N + 3, N + 7], jnp.int32))
    t = churn.stage(churn.with_staging(search.IVF.attach(tindex, nprobe=L),
                                       64), adds[:50], np.arange(N, N + 50))
    t = churn.tombstone(t, [N + 3, N + 7])
    Q = np.random.RandomState(9).randn(B, DIM).astype(np.float32)
    QR = Q @ np.asarray(jindex.R)
    lut = np.asarray(jindex.quantizer.adc_tables(jnp.asarray(QR)))
    tl = index_search.build_luts(tindex.quantizer, _t(QR), lut_dtype)
    jl = (jnp.asarray(lut) if lut_dtype == "float32" else
          tuple(jnp.asarray(p.numpy()) for p in tl))
    tl = _t(lut) if lut_dtype == "float32" else tl
    js, ji = jchurn.staged_topk(j.staging, jnp.asarray(QR), jl,
                                jindex.centroids, 10)
    ts_, ti = churn.staged_topk(t.staging, _t(QR), tl, tindex.centroids, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), atol=SCORE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("compact_at", [0.1, 0.05])
def test_engine_churn_stats_match_jax(compact_at):
    """The same adds and removes through a ChurnController on each
    package's Engine: the churn block has the same keys and the same counts
    (timings left out). At the JAX test's compact_at 0.1 no compaction
    fires; at 0.05 both packages compact, grow the same and reset the
    tombstone gauge the same."""
    jindex, tindex, _, adds = _dyadic()
    Q = np.random.RandomState(4).randn(B, DIM).astype(np.float32)
    jeng = jsearch.Engine(jsearch.make("ivf"), jsearch.IVF.attach(
        jindex, nprobe=L, fused_refresh=True), k=10, nprobe=L, min_bucket=4)
    teng = search.Engine(search.make("ivf"), search.IVF.attach(
        tindex, nprobe=L, fused_refresh=True), k=10, nprobe=L, min_bucket=4)
    jctl = jchurn.ChurnController(jeng, staging_rows=64, flush_at=0.5,
                                  compact_at=compact_at)
    tctl = churn.ChurnController(teng, staging_rows=64, flush_at=0.5,
                                 compact_at=compact_at)
    rng = np.random.default_rng(11)
    live = list(range(N))
    for step in range(10):
        dead = rng.choice(live, size=12, replace=False).astype(np.int32)
        live = [i for i in live if i not in set(dead.tolist())]
        add_ids = np.arange(N + 12 * step, N + 12 * (step + 1),
                            dtype=np.int32)
        add = adds[12 * step:12 * (step + 1)]
        jctl.step(add=jnp.asarray(add), add_ids=add_ids, remove_ids=dead)
        tctl.step(add=add, add_ids=add_ids, remove_ids=dead)
        jres = jeng.search(jnp.asarray(Q))
        tres = teng.search(_t(Q))
        np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    timing = ("flush_ms_p95", "compact_hidden_ms_total")
    jch, tch = jeng.stats()["churn"], teng.stats()["churn"]
    assert set(tch) == set(jch)
    assert {k: v for k, v in tch.items() if k not in timing} == {
        k: v for k, v in jch.items() if k not in timing}
    assert tch["flushes"] >= 1
    assert (tch["compactions"] >= 1) == (compact_at < 0.1), tch


# ---------------------------------------------------------------------------
# The churn benchmark at the JAX script's --fast sizes
# ---------------------------------------------------------------------------


def test_churn_bench_fast_on_cpu():
    """``bench.churn.run`` at ``--fast`` sizes: six of the seven checks and
    the shapes held. ``recall_within_rebuild`` (a fresh k-means on the live
    rows against the churned index's quantizers) is reported, not held: at
    these sizes the JAX script fails it too (0.450 against a fresh build's
    0.461), while the churned index equals the same-quantizer repack
    exactly in both packages."""
    results, checks = bench.run(**bench.FAST, verbose=False, device="cpu")
    held = {k: v for k, v in checks.items() if k != "recall_within_rebuild"}
    assert all(held.values()), (checks, results)
    assert results["shapes_kept"] and results["new_executables"] == 0
    assert results["recall_churn"] == results["recall_repack"], results
