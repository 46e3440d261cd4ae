"""The port's depth-M residual quantizer (``repro_torch.quant.rq``) and what
it runs through (the IVF build, ``convert``, the searchers, the refresh,
churn, the fused LUT build, ``bench.ivf_recall_qps``) against the JAX
package on the CPU.

A torch generator cannot draw a JAX key's numbers (``ROADMAP.md`` parity
hazard "PRNG"), so the parity tests hand the port the JAX package's fitted
codebooks, or a depth-2 index the JAX package built, carried across by
``convert``. Where codes are compared for equality the inputs are dyadic
(codebooks and vectors on a grid of 1/4 or 1/8), so every distance is exact
in float32 and both packages must choose the same codes, ties to the first
codeword. The port's own fit is held by property: distortion falls with
depth.
"""
from __future__ import annotations

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
from repro.core import givens as jgivens
from repro.data import synthetic as jsynth
from repro.index import ivf as jivf
from repro.index import maintain as jmaintain
from repro.kernels import ops as jops
from repro.quant import kmeans as jkmeans
from repro_torch import churn, convert, quant, rotations, search
from repro_torch.bench import ivf_recall_qps
from repro_torch.data import synthetic
from repro_torch.index import ivf as tivf
from repro_torch.index import maintain as tmaintain
from repro_torch.kernels import ref as tref
from repro_torch.quant import kmeans as tkmeans

DIM, D, K, L, BS = 16, 4, 16, 8, 8
N = 2000


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _index_arrays(index) -> dict:
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size)


def _dyadic_rq(M: int = 2, m: int = 64, seed: int = 0):
    """Codebooks (M, D, K, sub) with level l on a grid of 1/2^(l+2) and rows
    on a grid of 1/4: every residual and distance is exact in float32."""
    rng = np.random.RandomState(seed)
    cbs = np.stack([(rng.randint(-8, 9, (D, K, DIM // D)) / 2 ** (lvl + 2))
                    for lvl in range(M)]).astype(np.float32)
    X = (rng.randint(-12, 13, (m, DIM)) / 4).astype(np.float32)
    return cbs, X


@pytest.fixture(scope="module")
def fitted():
    """(JAX RQ-2 fitted on sift_like rows, the port's RQ on its codebooks,
    the rows)."""
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), 1024, DIM))
    jrq, _ = jquant.fit_quantizer(jax.random.PRNGKey(1), jnp.asarray(X),
                                  jquant.PQConfig(D, K), depth=2, iters=4)
    trq = quant.RQ(_t(jrq.codebooks))
    return jrq, trq, X


@pytest.fixture(scope="module")
def rq_index():
    """(JAX depth-2 index, the port's copy, corpus X, queries Q)."""
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(20), N, DIM))
    R = np.asarray(jgivens.random_rotation(jax.random.PRNGKey(21), DIM))
    cfg = jivf.IVFPQConfig(num_lists=L, pq=jquant.PQConfig(D, K),
                           block_size=BS, depth=2)
    jindex = jivf.build(jax.random.PRNGKey(22), jnp.asarray(X),
                        jnp.asarray(R), cfg, coarse_iters=5, pq_iters=5)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    Q = np.asarray(jsynth.sift_like(jax.random.PRNGKey(23), 16, DIM))
    return jindex, tindex, X, Q


# -- the quantizer ----------------------------------------------------------


def test_rq_lift_is_complete():
    """The depth > 1 gate is gone: no RQ_LATER, and fit_quantizer picks the
    scheme by depth."""
    assert not hasattr(quant, "RQ_LATER")
    g = torch.Generator().manual_seed(0)
    X = torch.randn(256, DIM, generator=g)
    pq, tr1 = quant.fit_quantizer(g, X, quant.PQConfig(D, K), depth=1,
                                  iters=3)
    rq, tr2 = quant.fit_quantizer(g, X, quant.PQConfig(D, K), depth=2,
                                  iters=3)
    assert isinstance(pq, quant.PQ) and tr1.shape == (3,)
    assert isinstance(rq, quant.RQ) and tr2.shape == (2, 3)


@pytest.mark.parametrize("M", [2, 3])
def test_rq_shape_facts_match_jax(M):
    cbs, _ = _dyadic_rq(M)
    j, t = jquant.RQ(jnp.asarray(cbs)), quant.RQ(_t(cbs))
    for name in ("num_levels", "num_subspaces", "num_codewords", "sub",
                 "dim", "code_width"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.code_width == M * D
    assert t.code_dtype == torch.uint8
    assert tuple(t.config) == tuple(j.config)


@pytest.mark.parametrize("M", [2, 3])
def test_rq_encode_matches_jax_on_dyadic_inputs(M):
    """Greedy residual encoding, level-major: equal codes, ties to the
    first codeword in both."""
    cbs, X = _dyadic_rq(M, seed=M)
    want = np.asarray(jquant.RQ(jnp.asarray(cbs)).encode(jnp.asarray(X)))
    got = quant.RQ(_t(cbs)).encode(_t(X))
    assert got.dtype == torch.int32 and got.shape == (X.shape[0], M * D)
    np.testing.assert_array_equal(got.numpy(), want)
    # level-major: the first D columns are a PQ encode of X
    np.testing.assert_array_equal(
        got[:, :D].numpy(),
        quant.PQ(_t(cbs[0])).encode(_t(X)).numpy())


def test_rq_decode_and_tables_match_jax(fitted):
    jrq, trq, X = fitted
    codes = np.asarray(jrq.encode(jnp.asarray(X)))
    np.testing.assert_allclose(trq.decode(_t(codes)).numpy(),
                               np.asarray(jrq.decode(jnp.asarray(codes))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        trq.decode(_t(codes.astype(np.uint8))).numpy(),
        np.asarray(jrq.decode(jnp.asarray(codes))), atol=1e-6, rtol=0)
    Q = X[:8] * 0.5
    want = np.asarray(jrq.adc_tables(jnp.asarray(Q)))
    got = trq.adc_tables(_t(Q))
    assert got.shape == (8, 2 * D, K)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


def test_rq_lut_operands_match_jax(fitted):
    jrq, trq, _ = fitted
    jcb, jcol = jrq.lut_operands()
    tcb, tcol = trq.lut_operands()
    np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    from repro_torch.kernels import ops as tops
    np.testing.assert_array_equal(tops.lut_column_map(tcol).numpy(),
                                  np.arange(2 * D) % D)


def test_rq_distortion_matches_jax(fitted):
    jrq, trq, X = fitted
    want = float(jrq.distortion(jnp.asarray(X)))
    got = float(trq.distortion(_t(X)))
    assert abs(got - want) <= 1e-6 * abs(want)
    codes = np.asarray(jrq.encode(jnp.asarray(X)))
    want_c = float(jrq.distortion(jnp.asarray(X), jnp.asarray(codes)))
    got_c = float(trq.distortion(_t(X), _t(codes)))
    assert abs(got_c - want_c) <= 1e-6 * abs(want_c)


def test_rq_rotate_matches_jax(fitted):
    """One rotate_codebooks call over every level's (M·K, n) rows."""
    jrq, trq, _ = fitted
    pi = np.array([0, 5, 9, 14], np.int32)
    pj = np.array([1, 6, 11, 12], np.int32)
    theta = np.array([0.3, -0.2, 0.11, 0.05], np.float32)
    want = jrq.rotate(jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(theta))
    got = trq.rotate(_t(pi), _t(pj), _t(theta))
    assert isinstance(got, quant.RQ)
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks), atol=1e-6, rtol=0)


def test_rq_encode_st_forward_and_gradient(fitted):
    jrq, trq, X = fitted
    x = _t(X[:32]).requires_grad_(True)
    y = trq.encode_st(x)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jrq.encode_st(jnp.asarray(X[:32]))),
                               atol=1e-6, rtol=0)
    w = torch.linspace(-1, 1, DIM)
    (g,) = torch.autograd.grad((y * w).sum(), x)
    np.testing.assert_array_equal(g.numpy(),
                                  np.broadcast_to(w.numpy(), g.shape))
    jg = jax.grad(lambda a: jnp.sum(jrq.encode_st(a) * jnp.asarray(w)))(
        jnp.asarray(X[:32]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_vq_encode_st_matches_jax():
    rng = np.random.RandomState(4)
    C = rng.randn(6, DIM).astype(np.float32)
    X = rng.randn(20, DIM).astype(np.float32)
    j, t = jquant.VQ(jnp.asarray(C)), quant.VQ(_t(C))
    x = _t(X).requires_grad_(True)
    y = t.encode_st(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(j.encode_st(jnp.asarray(X))))
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(X))


@given(seed=st.integers(0, 2**16))
@settings(deadline=None, max_examples=8, database=None, derandomize=True)
def test_rq_distortion_falls_with_depth(seed):
    """The port's own fit: each level is fit on the residual the levels
    before it leave, so the distortion of depth M + 1 is below depth M's."""
    g = torch.Generator().manual_seed(seed)
    X = synthetic.sift_like(g, 512, DIM, device="cpu")
    cfg = quant.PQConfig(D, 8)
    prev = None
    for depth in (1, 2, 3):
        q, _ = quant.fit_quantizer(torch.Generator().manual_seed(seed + 1),
                                   X, cfg, depth=depth, iters=4)
        dist = float(q.distortion(X))
        assert prev is None or dist < prev, (depth, dist, prev)
        prev = dist


# -- EMA updates --------------------------------------------------------------


@pytest.mark.parametrize("decay", [0.5, 0.99])
def test_codebook_ema_update_matches_jax(decay):
    """The index_add_ sums against the JAX segment sums, on dyadic rows
    (every sum exact), with codewords no row chose kept as they were."""
    rng = np.random.RandomState(7)
    cb = (rng.randint(-8, 9, (D, K, DIM // D)) / 4).astype(np.float32)
    X = (rng.randint(-8, 9, (40, DIM)) / 4).astype(np.float32)
    codes = rng.randint(0, K // 2, (40, D)).astype(np.int32)
    want = np.asarray(jkmeans.codebook_ema_update(
        jnp.asarray(cb), jnp.asarray(X), jnp.asarray(codes), decay=decay))
    got = tkmeans.codebook_ema_update(_t(cb), _t(X), _t(codes), decay=decay)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, K // 2:].numpy(), cb[:, K // 2:])
    pq = quant.PQ(_t(cb)).ema_update(_t(X), _t(codes), decay=decay)
    jpq = jquant.PQ(jnp.asarray(cb)).ema_update(jnp.asarray(X),
                                                jnp.asarray(codes),
                                                decay=decay)
    assert isinstance(pq, quant.PQ)
    np.testing.assert_array_equal(pq.codebooks.numpy(),
                                  np.asarray(jpq.codebooks))


def test_ema_update_moves_codebooks_toward_data():
    X = torch.ones((64, 8)) * 3.0
    cb = torch.zeros((2, 4, 4))
    codes = quant.codebook.assign(X, cb)
    cb2 = tkmeans.codebook_ema_update(cb, X, codes, decay=0.5)
    assert float(cb2.max()) == 1.5


# -- the depth-2 index ------------------------------------------------------


def test_rq_index_from_numpy(rq_index):
    jindex, tindex, _, _ = rq_index
    assert isinstance(tindex.quantizer, quant.RQ)
    assert tindex.codes.dtype == torch.uint8
    assert tindex.codes.shape == (jindex.capacity, 2 * D)
    np.testing.assert_array_equal(tindex.codes.numpy(),
                                  np.asarray(jindex.codes))
    with pytest.raises(ValueError):
        convert.index_from_numpy(dict(_index_arrays(jindex),
                                      codebooks=np.zeros((2, 3))),
                                 device="cpu")


@pytest.mark.parametrize("nprobe", [3, L])
def test_rq_ivf_search_matches_jax(rq_index, nprobe):
    jindex, tindex, _, Q = rq_index
    want = jsearch.make("ivf").search(
        jsearch.IVF.attach(jindex, nprobe=nprobe), jnp.asarray(Q), k=10,
        nprobe=nprobe)
    ivf = search.make("ivf")
    got = ivf.search(ivf.attach(tindex), _t(Q), k=10, nprobe=nprobe)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    # the scores are about 120 here, where float32 sums in another order
    # part by a few ulps (7.6e-6 each): 1e-5 absolute plus 1e-6 relative
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5, rtol=1e-6)


def test_rq_full_probe_equals_flat_adc(rq_index):
    jindex, tindex, _, Q = rq_index
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    a = ivf.search(ivf.attach(tindex), _t(Q), k=10, nprobe=L)
    b = flat.search(flat.attach(tindex), _t(Q), k=10)
    assert torch.equal(a.ids, b.ids)
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), atol=1e-5,
                               rtol=0)
    want = jsearch.make("flat_adc").search(
        jsearch.FlatADC.attach(jindex), jnp.asarray(Q), k=10)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5, rtol=1e-6)


def _subspace_delta(jindex, seed: int):
    G = jax.random.normal(jax.random.PRNGKey(seed), (DIM, DIM))
    learner = jrot.make("subspace_gcd", sub=DIM // D)
    _, delta = learner.update(learner.init_from(jindex.R), G, 2e-3,
                              jax.random.PRNGKey(0))
    tdelta = rotations.GivensDelta(pi=_t(delta.pi), pj=_t(delta.pj),
                                   theta=_t(delta.theta))
    return delta, tdelta


def test_rq_refresh_rotation_matches_jax(rq_index):
    jindex, tindex, X, Q = rq_index
    jdelta, tdelta = _subspace_delta(jindex, 24)
    want = jmaintain.refresh_rotation(jindex, jdelta.pi, jdelta.pj,
                                      jdelta.theta)
    got = tmaintain.refresh_rotation(tindex, tdelta.pi, tdelta.pj,
                                     tdelta.theta)
    for name in ("R", "centroids", "codebooks"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert got.codes is tindex.codes
    want_m = float(jmaintain.refresh_mismatch(want, jnp.asarray(X)))
    got_m = tmaintain.refresh_mismatch(got, _t(X))
    assert got_m <= 0.01 and abs(got_m - want_m) <= 2.0 / N
    # scores are inner products: a rotation of both sides keeps them
    ivf = search.make("ivf")
    a = ivf.search(ivf.attach(tindex), _t(Q), k=10, nprobe=L)
    b = ivf.search(ivf.attach(got), _t(Q), k=10, nprobe=L)
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_rq_fused_engine_refresh_keeps_tables(rq_index):
    """A fused-refresh RQ state: the column map is level-major (Dp = M·D),
    and a within-subspace refresh makes no executable and drops no table;
    the fused tables equal the eager tables of the refreshed index."""
    _, tindex, _, Q = rq_index
    flat = search.make("flat_adc")
    state = flat.attach(tindex, fused_refresh=True)
    np.testing.assert_array_equal(state.lut_cols.numpy(),
                                  np.arange(2 * D) % D)
    eng = search.Engine(flat, state, k=10, min_bucket=16)
    eng.search(_t(Q))
    before = eng.stats()
    _, tdelta = _subspace_delta_from_R(tindex.R, 25)
    eng.refresh(tdelta)
    res = eng.search(_t(Q))
    after = eng.stats()
    assert after["executables"] == before["executables"]
    assert after["lut_invalidations"] == 0 and after["lut_epoch"] == 0
    eager = flat.search(flat.attach(tmaintain.refresh_delta(tindex, tdelta)),
                        _t(Q), k=10)
    assert np.mean(res.ids.numpy() == eager.ids.numpy()) >= 0.95
    QR = flat.rotate_queries(eng.state, _t(Q))
    fused = flat.luts(eng.state, QR)
    refreshed = tmaintain.refresh_delta(tindex, tdelta)
    eager_lut = refreshed.quantizer.adc_tables(_t(Q) @ refreshed.R)
    np.testing.assert_allclose(fused.numpy(), eager_lut.numpy(), atol=1e-4,
                               rtol=1e-4)


def _subspace_delta_from_R(R: torch.Tensor, seed: int):
    G = torch.randn(R.shape, generator=torch.Generator().manual_seed(seed))
    learner = rotations.make("subspace_gcd", sub=DIM // D)
    return learner.update(learner.init_from(R), G, 2e-3)


def _dyadic_rq_index():
    """A depth-2 index whose every distance is exact in float32 (R a signed
    permutation, centroids on a grid of 1/2, level codebooks on grids of
    1/4 and 1/8, vectors on 1/4): (JAX index, port index, X, adds)."""
    rng = np.random.RandomState(5)
    R = np.eye(DIM, dtype=np.float32)[rng.permutation(DIM)] * np.where(
        rng.rand(DIM) < 0.5, -1.0, 1.0).astype(np.float32)[:, None]
    cent = (rng.randint(-4, 5, (L, DIM)) / 2).astype(np.float32)
    cbs, _ = _dyadic_rq(2, seed=9)
    X = (rng.randint(-8, 9, (600, DIM)) / 4).astype(np.float32)
    adds = (rng.randint(-8, 9, (60, DIM)) / 4).astype(np.float32)
    coarse = jquant.VQ(centroids=jnp.asarray(cent))
    rq = jquant.RQ(codebooks=jnp.asarray(cbs))
    lists, codes = jivf.encode(jnp.asarray(X) @ jnp.asarray(R), coarse, rq)
    jindex = jivf.pack(jnp.asarray(R), coarse, rq, codes, lists,
                       jnp.arange(600, dtype=jnp.int32), block_size=BS)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    return jindex, tindex, X, adds


def test_rq_encode_and_pack_match_jax_on_dyadic_inputs():
    jindex, tindex, X, _ = _dyadic_rq_index()
    lists, codes = tivf.encode(_t(X) @ tindex.R, tindex.coarse,
                               tindex.quantizer)
    jl, jc = jivf.encode(jnp.asarray(X) @ jindex.R, jindex.coarse,
                         jindex.quantizer)
    np.testing.assert_array_equal(lists.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    packed = tivf.pack(tindex.R, tindex.coarse, tindex.quantizer, codes,
                       lists, torch.arange(600, dtype=torch.int32),
                       block_size=BS)
    for f in ("codes", "ids", "list_offsets"):
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      np.asarray(getattr(jindex, f)))


def test_rq_churn_matches_jax_on_dyadic_inputs():
    """stage → tombstone → flush on the depth-2 index through both
    packages' churn ops (the counterparts of ``tests/test_quant.py``'s RQ
    add/remove): the CSR and the buffer equal after every step."""
    jindex, tindex, _, adds = _dyadic_rq_index()
    j = jchurn.with_staging(jsearch.IVF.attach(jindex, nprobe=L), 32)
    t = churn.with_staging(search.IVF.attach(tindex, nprobe=L), 32)
    steps = [("stage", adds[:20], np.arange(600, 620)),
             ("tombstone", np.arange(0, 40)),
             ("flush",),
             ("stage", adds[20:50], np.arange(620, 650)),
             ("tombstone", np.array([601, 633, 50])),
             ("flush",)]
    for step in steps:
        if step[0] == "stage":
            j = jchurn.stage(j, jnp.asarray(step[1]),
                             step[2].astype(np.int32))
            t = churn.stage(t, step[1], step[2])
        elif step[0] == "tombstone":
            j = jchurn.tombstone(j, jnp.asarray(step[1], jnp.int32))
            t = churn.tombstone(t, step[1])
        else:
            j, _ = jchurn.flush(j)
            t, _ = churn.flush(t)
        for f in ("ids", "list_offsets", "codes"):
            np.testing.assert_array_equal(getattr(t.index, f).numpy(),
                                          np.asarray(getattr(j.index, f)),
                                          err_msg=f"{step[0]}: {f}")
        for f in ("ids", "lists", "codes"):
            np.testing.assert_array_equal(getattr(t.staging, f).numpy(),
                                          np.asarray(getattr(j.staging, f)),
                                          err_msg=f"{step[0]}: staging {f}")
    assert t.staging.codes.shape[1] == 2 * D
    assert churn.live_rows(t) == jchurn.live_rows(j) == 600 - 40 + 50 - 3


def test_rq_build_on_the_port():
    """``ivf.build`` at depth 2 on the port's own fit: uint8 codes of width
    M·D, every row placed once, and nprobe = L equal to the flat scan."""
    g = torch.Generator().manual_seed(3)
    X = synthetic.sift_like(g, 1500, DIM, device="cpu")
    cfg = tivf.IVFPQConfig(num_lists=L, pq=quant.PQConfig(D, K),
                           block_size=BS, depth=2)
    index = tivf.build(g, X, torch.eye(DIM), cfg, coarse_iters=4,
                       pq_iters=4, device="cpu")
    assert isinstance(index.quantizer, quant.RQ)
    assert index.codes.dtype == torch.uint8
    assert index.codes.shape[1] == 2 * D
    ids = index.ids[index.ids >= 0]
    assert torch.equal(torch.sort(ids).values,
                       torch.arange(1500, dtype=torch.int32))
    assert tmaintain.refresh_mismatch(index, X) == 0.0
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    Q = X[:8]
    a = ivf.search(ivf.attach(index), Q, k=10, nprobe=L)
    b = flat.search(flat.attach(index), Q, k=10)
    assert torch.equal(a.ids, b.ids)


def test_fused_lut_rq_colmap_matches_jax_kernel():
    """The level-major column map through the port's plain fused_lut and
    the JAX Pallas kernel in interpret mode (the counterpart of
    ``tests/test_kernels.py::test_fused_lut_rq_colmap``)."""
    rng = np.random.RandomState(9)
    b, n, M = 5, DIM, 2
    sub = n // D
    Q = rng.randn(b, n).astype(np.float32)
    qdelta = rng.randn(n, n).astype(np.float32)
    cb = rng.randn(M * D, K, sub).astype(np.float32)
    colmap = np.eye(D, dtype=np.float32)[np.arange(M * D) % D]
    want = np.asarray(jops.fused_lut(jnp.asarray(Q), jnp.asarray(qdelta),
                                     jnp.asarray(cb), jnp.asarray(colmap)))
    got = tref.fused_lut_ref(_t(Q), _t(qdelta), _t(cb), _t(colmap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    QL = (Q @ qdelta).reshape(b, D, sub)
    for p in range(M * D):
        np.testing.assert_allclose(got[:, p].numpy(),
                                   QL[:, p % D] @ cb[p].T, atol=1e-4,
                                   rtol=1e-4)


def test_ivf_recall_qps_bench_on_cpu():
    """The port of benchmarks/ivf_recall_qps.py at a tiny size: every check
    computed, RQ-2 beats PQ, the registry swept (the sharded twins on one
    CPU shard, at parity), and --devices on the CPU needs the shards
    named."""
    results, checks = ivf_recall_qps.run(
        n=3000, dim=16, queries=16, lists=16, subspaces=4, codewords=16,
        depths=(1, 2), verbose=False, device="cpu")
    assert set(checks) == {
        "streaming_matches_exact", "pq_int8_recall_within_0.01",
        "rq2_int8_recall_within_0.01", "pq_scan_reduction_at_recall",
        "engine_compile_cache", "fused_refresh_no_recompile",
        "fused_refresh_no_lut_invalidation", "rq2_end_to_end",
        "rq_beats_pq_quantization", "registry_swept", "sharded_parity"}
    assert checks["rq_beats_pq_quantization"]
    assert checks["rq2_end_to_end"] and checks["registry_swept"]
    assert checks["streaming_matches_exact"]
    assert results["rq2"]["residual_distortion"] < \
        results["pq"]["residual_distortion"]
    assert checks["sharded_parity"]
    assert {"exact_sharded", "flat_sharded", "ivf_sharded"} <= set(
        search.names())
    with pytest.raises(ValueError, match="--shard-device"):
        ivf_recall_qps.run(n=100, devices=2, device="cpu")
