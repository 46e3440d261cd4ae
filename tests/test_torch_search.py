"""The port's serving front end (``repro_torch.search``: fused refresh, the
exact backends, the Engine, the registry) against the JAX package on the
CPU.

One small IVF-PQ index is built by the JAX package and carried across with
``convert``, so both packages serve the very same codes; a JAX state taken
after several fused refreshes is carried across as it stands. Deltas come
from the JAX ``subspace_gcd`` learner and are handed to both packages as
numpy. The JAX side searches with its jnp oracles (``use_kernel=False``),
the port with its plain versions because its tensors lie on the CPU.

Tolerances: ids exactly (both packages rank equal scores by ascending id);
scores to atol = rtol = 1e-5 (float32 sums in another order, scores of a
few hundred); the fused-refresh matrices to 1e-6 (n-term float32
products).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rotations as jrot
from repro import search as jsearch
from repro.data import synthetic as jsynth
from repro_torch import convert, rotations, search
from repro_torch.metrics import recall_at_k

DIM, SUB, K, L, BS = 16, 4, 16, 8, 8
N, B = 600, 64
CFG = dict(num_lists=L, subspaces=SUB, codewords=K, block_size=BS, nprobe=4,
           tile_rows=128)
TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("requests", "queries", "compiles", "executables", "refreshes",
            "lut_hits", "lut_misses", "lut_invalidations", "lut_evictions",
            "lut_epoch", "lut_cached_rows")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _index_arrays(index) -> dict:
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size)


def _state_arrays(state) -> dict:
    """A JAX ADCState as the dict ``convert.adc_state_from_numpy`` takes."""
    arrays = _index_arrays(state.index)
    if state.rot is not None:
        arrays.update(rot=np.asarray(state.rot), wacc=np.asarray(state.wacc),
                      qdelta=np.asarray(state.qdelta))
    return arrays


def _tdelta(delta) -> rotations.GivensDelta:
    return rotations.GivensDelta(pi=_t(delta.pi), pj=_t(delta.pj),
                                 theta=_t(delta.theta))


def _subspace_delta(R, key: int):
    """A genuine subspace-GCD delta (what a training step emits)."""
    G = jax.random.normal(jax.random.PRNGKey(100 + key), (DIM, DIM))
    learner = jrot.make("subspace_gcd", sub=DIM // SUB)
    _, delta = learner.update(learner.init_from(jnp.asarray(R)), G, 1e-3,
                              jax.random.PRNGKey(key))
    return delta


def _cross_delta():
    """Two planes that straddle subspaces: they invalidate the LUT cache."""
    return jrot.GivensDelta(pi=jnp.array([0, 5]), pj=jnp.array([DIM - 1, 9]),
                            theta=jnp.array([1e-3, -2e-3], jnp.float32))


@pytest.fixture(scope="module")
def data():
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), N, DIM))
    Q = np.asarray(jsynth.sift_like(jax.random.PRNGKey(2), B, DIM))
    R = np.linalg.qr(np.random.RandomState(1).randn(DIM, DIM))[0].astype(
        np.float32)
    jstate = jsearch.make("ivf").build(jax.random.PRNGKey(3), jnp.asarray(X),
                                       jnp.asarray(R),
                                       jsearch.SearchConfig(**CFG))
    tindex = convert.index_from_numpy(_index_arrays(jstate.index),
                                      device="cpu")
    return X, Q, R, jstate.index, tindex


def _assert_same(got, want) -> None:
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_names_aliases_and_canonical():
    from repro.search import registry as jregistry

    assert search.names() == ("exact", "exact_stream", "flat_adc", "ivf")
    assert set(search.names()) <= set(jsearch.names())
    for alias in search._ALIASES:
        assert search.canonical(alias) == jregistry.canonical(alias)
        assert type(search.make(alias)).name == search.canonical(alias)
    for name in search.names():
        assert search.canonical(name) == name
        assert isinstance(search.make(name), search.Searcher)
    with pytest.raises(ValueError, match="unknown search backend"):
        search.make("no_such_backend")
    with pytest.raises(NotImplementedError, match="queue 11"):
        search.make("ivf_sharded")


# ---------------------------------------------------------------------------
# Fused refresh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["flat_adc", "ivf"])
def test_fused_state_matches_jax_after_deltas(data, backend):
    """Three subspace-GCD deltas into a fused state in both packages: the
    query-side matrices agree, and so does what the states serve. The JAX
    state taken after them carries across and serves the same."""
    _, Q, R, jindex, tindex = data
    jsr, tsr = jsearch.make(backend), search.make(backend)
    jstate = jsr.attach(jindex, fused_refresh=True)
    tstate = tsr.attach(tindex, fused_refresh=True)
    assert tsr.stats(tstate)["fused_refresh"] is True
    for i in range(3):
        d = _subspace_delta(R, i)
        jstate = jsr.refresh(jstate, d)
        tstate = tsr.refresh(tstate, _tdelta(d))
    for name in ("rot", "wacc", "qdelta"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   atol=1e-6, rtol=0)
    assert torch.equal(tstate.index.R, tindex.R)     # the index stays
    want = jsr.search(jstate, jnp.asarray(Q), k=10)
    _assert_same(tsr.search(tstate, _t(Q), k=10), want)
    carried = convert.adc_state_from_numpy(_state_arrays(jstate), fused=True,
                                           nprobe=jstate.nprobe,
                                           device="cpu")
    _assert_same(tsr.search(carried, _t(Q), k=10), want)


def test_fused_refresh_matches_eager_refresh(data):
    """Fused (query-side) and eager (corpus-side) refresh are the same
    math: after the same deltas the two states serve matching top-k
    (the bar of tests/test_search.py: 1e-4 and 95% of ids)."""
    _, Q, R, _, tindex = data
    flat = search.make("flat_adc")
    eager = flat.attach(tindex)
    fused = flat.attach(tindex, fused_refresh=True)
    for i in range(3):
        d = _tdelta(_subspace_delta(R, i))
        eager = flat.refresh(eager, d)
        fused = flat.refresh(fused, d)
    r_e = flat.search(eager, _t(Q), k=10)
    r_f = flat.search(fused, _t(Q), k=10)
    np.testing.assert_allclose(r_e.scores.numpy(), r_f.scores.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert np.mean(r_e.ids.numpy() == r_f.ids.numpy()) >= 0.95


def test_luts_refresh_invariant_only_for_fused_within_subspace(data):
    _, _, R, jindex, tindex = data
    ivf, jivf = search.make("ivf"), jsearch.make("ivf")
    within, cross = _subspace_delta(R, 0), _cross_delta()
    for fused in (False, True):
        t = ivf.attach(tindex, fused_refresh=fused)
        j = jivf.attach(jindex, fused_refresh=fused)
        for d in (within, cross):
            assert ivf.luts_refresh_invariant(t, _tdelta(d)) \
                == jivf.luts_refresh_invariant(j, d)
    assert ivf.luts_refresh_invariant(
        ivf.attach(tindex, fused_refresh=True), _tdelta(within))


def test_fused_int8_luts_match_jax(data):
    _, Q, R, jindex, tindex = data
    jstate = jsearch.make("flat_adc").attach(jindex, lut_dtype="int8",
                                             fused_refresh=True)
    tstate = search.make("flat_adc").attach(tindex, lut_dtype="int8",
                                            fused_refresh=True)
    d = _subspace_delta(R, 4)
    jstate = jsearch.make("flat_adc").refresh(jstate, d)
    tstate = search.make("flat_adc").refresh(tstate, _tdelta(d))
    jq, js = jsearch.make("flat_adc").luts(
        jstate, jsearch.make("flat_adc").rotate_queries(jstate,
                                                        jnp.asarray(Q)))
    tq, ts = search.make("flat_adc").luts(
        tstate, search.make("flat_adc").rotate_queries(tstate, _t(Q)))
    assert tq.dtype == torch.int8
    assert np.max(np.abs(tq.numpy().astype(int) - np.asarray(jq))) <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_from_quantizer_serves_the_quantizers_codes(data):
    X, Q, _, jindex, tindex = data
    R = tindex.R
    jstate = jsearch.FlatADC.from_quantizer(jnp.asarray(R.numpy()),
                                            _jpq(jindex), jnp.asarray(X),
                                            block_size=BS)
    tstate = search.FlatADC.from_quantizer(R, tindex.quantizer, _t(X),
                                           block_size=BS)
    np.testing.assert_array_equal(tstate.index.codes.numpy(),
                                  np.asarray(jstate.index.codes))
    _assert_same(search.make("flat_adc").search(tstate, _t(Q), k=10),
                 jsearch.make("flat_adc").search(jstate, jnp.asarray(Q),
                                                 k=10))


def _jpq(jindex):
    from repro import quant as jquant

    return jquant.PQ(jnp.asarray(jindex.codebooks))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

# (rows of the query pool, k, nprobe): ragged sizes 1, 3, 8, 13 and 40 (40
# is chunked at max_bucket 16), repeated rows across and inside batches, a
# new k and an oversized nprobe; "within" and "cross" are refreshes
REQUESTS = (
    ([0], None, None),
    ([0, 1, 2], None, None),
    (list(range(3, 11)), None, None),
    ([5, 6, 7] + list(range(11, 21)), None, None),
    (list(range(20, 52)) + [20, 21, 22, 0, 1, 2, 3, 3], None, None),
    "within",
    (list(range(8)), None, None),
    ([30, 30, 31], 5, None),
    (list(range(40, 53)), None, 10 * L),
    "cross",
    (list(range(13)), None, None),
    ([60, 61, 60], None, None),
)


def _engines(backend, jstate, tstate, **kw):
    nprobe = {"nprobe": CFG["nprobe"]} if backend == "ivf" else {}
    return (jsearch.Engine(jsearch.make(backend), jstate, k=10, **nprobe,
                           **kw),
            search.Engine(search.make(backend), tstate, k=10, **nprobe, **kw))


@pytest.mark.parametrize("backend,fused,lut_dtype", [
    ("ivf", True, "float32"), ("ivf", True, "int8"),
    ("flat_adc", True, "float32"), ("ivf", False, "float32")])
def test_engine_matches_jax_engine(data, backend, fused, lut_dtype):
    """One request sequence through the JAX Engine and the port's, from
    one index: equal results and equal counters after every request."""
    _, Q, R, jindex, tindex = data
    jstate = jsearch.make(backend).attach(jindex, lut_dtype=lut_dtype,
                                          fused_refresh=fused)
    tstate = search.make(backend).attach(tindex, lut_dtype=lut_dtype,
                                         fused_refresh=fused)
    jeng, teng = _engines(backend, jstate, tstate, min_bucket=4,
                          max_bucket=16, lut_cache_rows=24)
    for step, req in enumerate(REQUESTS):
        if isinstance(req, str):
            d = _subspace_delta(R, 7) if req == "within" else _cross_delta()
            jeng.refresh(d)
            teng.refresh(_tdelta(d))
        else:
            rows, k, nprobe = req
            kw = {"k": k}
            if nprobe is not None and backend == "ivf":
                kw["nprobe"] = nprobe
            want = jeng.search(Q[rows], **kw)
            got = teng.search(Q[rows], **kw)
            _assert_same(got, want)
        jst, tst = jeng.stats(), teng.stats()
        for key in COUNTERS:
            assert tst[key] == jst[key], (step, key, tst[key], jst[key])
    assert teng.stats()["lut_evictions"] > 0
    assert teng.stats()["lut_hits"] > 0
    want_inv = 1 if fused else 2
    assert teng.stats()["lut_invalidations"] == want_inv
    assert [r["nprobe"] for r in teng.requests] \
        == [r["nprobe"] for r in jeng.requests]
    assert teng.stats()["churn"] == {
        k: (v if k == "window" else 0 * v)
        for k, v in teng.stats()["churn"].items()}
    assert set(teng.stats()["churn"]) == set(jeng.stats()["churn"])


def test_engine_matches_direct_search(data):
    _, Q, _, _, tindex = data
    ivf = search.make("ivf")
    state = ivf.attach(tindex, fused_refresh=True)
    engine = search.Engine(ivf, state, k=10, nprobe=4, min_bucket=4)
    for b in (3, 7, 16):
        got = engine.search(_t(Q[:b]))
        want = ivf.search(state, _t(Q[:b]), k=10, nprobe=4)
        assert torch.equal(got.ids, want.ids)
        torch.testing.assert_close(got.scores, want.scores, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("backend", ["exact", "exact_stream"])
def test_engine_plain_path_matches_jax(data, backend):
    """Backends without a LUT path: the plain path, chunked at
    max_bucket; a host-loop backend counts no compile."""
    X, Q, R, _, _ = data
    cfg = jsearch.SearchConfig(**CFG)
    jstate = jsearch.make(backend).build(jax.random.PRNGKey(0),
                                         jnp.asarray(X), jnp.asarray(R), cfg)
    tstate = search.make(backend).build(None, _t(X), _t(R),
                                        search.SearchConfig(**CFG),
                                        device="cpu")
    jeng, teng = _engines(backend, jstate, tstate, min_bucket=4,
                          max_bucket=8)
    for rows in ([0, 1, 2], list(range(20)), [5]):
        _assert_same(teng.search(Q[rows]), jeng.search(Q[rows]))
        jst, tst = jeng.stats(), teng.stats()
        assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    st = teng.stats()
    assert st["lut_misses"] == 0 and st["searcher"]["backend"] == backend
    assert st["compiles"] == (0 if backend == "exact_stream" else 2)
    with pytest.raises(ValueError, match="empty query batch"):
        teng.search(np.zeros((0, DIM), np.float32))
    with pytest.raises(ValueError, match="does not take nprobe"):
        teng.search(Q[:4], nprobe=4)
    with pytest.raises(ValueError, match="does not take nprobe"):
        search.Engine(search.make(backend), tstate, nprobe=4)


def test_engine_lut_cache_keys_on_dtype(data):
    """A state of another lut_dtype swapped in under one Engine misses on
    the same queries, as in the JAX Engine: the dtype is in the key."""
    _, Q, _, jindex, tindex = data
    jflat, tflat = jsearch.make("flat_adc"), search.make("flat_adc")
    jeng = jsearch.Engine(jflat, jflat.attach(jindex, lut_dtype="int8"),
                          k=10, min_bucket=4)
    teng = search.Engine(tflat, tflat.attach(tindex, lut_dtype="int8"),
                         k=10, min_bucket=4)
    for eng, sr, index in ((jeng, jflat, jindex), (teng, tflat, tindex)):
        eng.search(Q[:8])
        eng.search(Q[:8])
        eng.state = sr.attach(index)
        eng.search(Q[:8])
    keys = ("lut_hits", "lut_misses", "lut_cached_rows")
    assert {k: teng.stats()[k] for k in keys} \
        == {k: jeng.stats()[k] for k in keys} \
        == {"lut_hits": 8, "lut_misses": 16, "lut_cached_rows": 16}
    assert teng._lut_key(Q[0])[1] == "float32"


def test_engine_submit_collect_split(data):
    _, Q, _, _, tindex = data
    engine = search.Engine(search.make("ivf"),
                           search.IVF.attach(tindex, nprobe=4), min_bucket=4)
    pending = engine.submit(Q[:5])
    assert engine.stats()["requests"] == 0       # counted at collect
    res = engine.collect(pending)
    assert res.ids.shape == (5, 10)
    assert engine.stats()["requests"] == 1
    with pytest.raises(ValueError, match="max_bucket"):
        search.Engine(search.make("ivf"), search.IVF.attach(tindex),
                      max_bucket=8).submit(Q[:9])


def test_engine_refresh_rejects_delta_of_another_size(data):
    _, _, _, _, tindex = data
    engine = search.Engine(search.make("ivf"), search.IVF.attach(tindex))
    big = rotations.GivensDelta(pi=torch.tensor([0]),
                                pj=torch.tensor([DIM + 3]),
                                theta=torch.tensor([0.1]))
    with pytest.raises(ValueError, match="different dimensions"):
        engine.refresh(big)


# ---------------------------------------------------------------------------
# Exact backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_exact_backends_match_jax(data, fused):
    """``exact`` (carried across and built by the port) and
    ``exact_stream`` against JAX, before and after a refresh."""
    X, Q, R, _, _ = data
    cfg = dict(CFG, fused_refresh=fused)
    jcfg, tcfg = jsearch.SearchConfig(**cfg), search.SearchConfig(**cfg)
    d = _subspace_delta(R, 1)
    for backend in ("exact", "exact_stream"):
        jsr, tsr = jsearch.make(backend), search.make(backend)
        jstate = jsr.build(jax.random.PRNGKey(0), jnp.asarray(X),
                           jnp.asarray(R), jcfg)
        tstate = tsr.build(None, _t(X), _t(R), tcfg, device="cpu")
        states = [tstate]
        if backend == "exact":
            states.append(convert.exact_state_from_numpy(
                dict(R=jstate.R, XR=jstate.XR, ids=jstate.ids,
                     tile_rows=jstate.tile_rows, R0=jstate.R0),
                device="cpu"))
        want = jsr.search(jstate, jnp.asarray(Q), k=10)
        for st in states:
            _assert_same(tsr.search(st, _t(Q), k=10), want)
        jstate = jsr.refresh(jstate, d)
        before = tstate
        tstate = tsr.refresh(tstate, _tdelta(d))
        np.testing.assert_allclose(tstate.R.numpy(), np.asarray(jstate.R),
                                   atol=1e-6)
        if backend == "exact":
            # fused: the corpus buffer is the very same tensor after it
            assert (tstate.XR is before.XR) is fused
        _assert_same(tsr.search(tstate, _t(Q), k=10),
                     jsr.search(jstate, jnp.asarray(Q), k=10))
        assert tsr.stats(tstate)["fused_refresh"] is fused


def test_streaming_exact_fused_refresh_moves_no_tiles(data):
    """Fused mode: refresh touches only R; the host tiles stay
    byte-identical and results stay exact."""
    X, Q, R, _, _ = data
    truth = np.argsort(-(Q @ X.T), axis=1)[:, :10]
    stream = search.make("exact_stream")
    state = stream.build(None, _t(X), _t(R),
                         search.SearchConfig(**CFG, fused_refresh=True),
                         device="cpu")
    tiles = [t.clone() for t in state.tiles]
    moved = stream.refresh(state, _tdelta(_subspace_delta(R, 2)))
    for a, b in zip(tiles, moved.tiles):
        assert torch.equal(a, b)
    assert float((moved.R - state.R).abs().max()) > 0
    res = stream.search(moved, _t(Q), k=10)
    assert recall_at_k(res.ids, truth) >= 0.999
    st = stream.stats(moved)
    assert st["streaming"] is True and st["fused_refresh"] is True


@pytest.mark.parametrize("backend", ["exact", "exact_stream"])
def test_exact_pads_when_k_exceeds_rows(data, backend):
    X, Q, R, _, _ = data
    X5 = X[:5]
    jstate = jsearch.make(backend).build(
        jax.random.PRNGKey(0), jnp.asarray(X5), jnp.asarray(R),
        jsearch.SearchConfig(tile_rows=4))
    tstate = search.make(backend).build(None, _t(X5), _t(R),
                                        search.SearchConfig(tile_rows=4),
                                        device="cpu")
    want = jsearch.make(backend).search(jstate, jnp.asarray(Q[:3]), k=8)
    got = search.make(backend).search(tstate, _t(Q[:3]), k=8)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert (got.ids[:, 5:] == -1).all()
    assert torch.isneginf(got.scores[:, 5:]).all()
    np.testing.assert_allclose(got.scores[:, :5].numpy(),
                               np.asarray(want.scores)[:, :5], **TOL)


def test_exact_merge_ties_go_to_the_smaller_id():
    """Equal rows in different tiles and inside one tile: the running
    merge ranks equal scores by ascending id, as topk_merge_ref does."""
    X = np.tile(np.eye(4, dtype=np.float32), (5, 1))      # 20 rows
    q = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    state = search.make("exact").build(None, _t(X), torch.eye(4),
                                       search.SearchConfig(tile_rows=6),
                                       device="cpu")
    got = search.make("exact").search(state, _t(q), k=5)
    np.testing.assert_array_equal(got.ids.numpy(), [[0, 4, 8, 12, 16]])


def test_state_conversion_keeps_dtypes_and_devices(data):
    _, _, _, jindex, _ = data
    state = convert.adc_state_from_numpy(_index_arrays(jindex), fused=False,
                                         nprobe=100, lut_dtype="uint8",
                                         device="cpu")
    assert state.nprobe == L and state.rot is None
    assert state.lut_dtype == "uint8"
    with pytest.raises(KeyError, match="fused"):
        convert.adc_state_from_numpy(_index_arrays(jindex), fused=True,
                                     device="cpu")
    fused = dataclasses.replace(state, lut_dtype="float32")
    assert fused.max_blocks == jindex.max_list_blocks()
