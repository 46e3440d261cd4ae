"""The port's quantizers, index and searchers (``repro_torch.quant``,
``repro_torch.index``, ``repro_torch.search``) against the JAX package on
the CPU.

A small index is built by the JAX package and carried across with
``convert.index_from_numpy``, so both packages search the very same codes.
JAX searches with its jnp oracle (``use_kernel=False``) at full size and
with its Pallas ``ivf_adc`` kernel in interpret mode on one tiny schedule
(S ≤ 64 tiles); the port takes its plain scans because its tensors lie on
the CPU. Scores agree to 1e-4 (float32 sums in another order); ids exactly,
since both break equal scores by ascending id.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import metrics as jmetrics
from repro import quant as jquant
from repro import rotations as jrot
from repro.data import synthetic as jsynth
from repro.index import ivf as jivf
from repro.index import maintain as jmaintain
from repro.index import search as jsearch
from repro.quant import kmeans as jkmeans
from repro_torch import convert, device, metrics, quant, rotations, search
from repro_torch.data import synthetic
from repro_torch.index import ivf as tivf
from repro_torch.index import maintain as tmaintain
from repro_torch.index import search as tsearch
from repro_torch.quant import kmeans as tkmeans

N, DIM, D, K, L, BS = 2000, 32, 4, 16, 8, 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _index_arrays(index: jivf.IVFPQIndex) -> dict:
    """A JAX-built index as the numpy dict ``index_from_numpy`` takes."""
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size)


@pytest.fixture(scope="module")
def built():
    """(JAX index, port index, corpus X, queries Q) from one numpy seed."""
    rng = np.random.RandomState(0)
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), N, DIM))
    Q = rng.randn(16, DIM).astype(np.float32) * 4.0
    R = np.linalg.qr(rng.randn(DIM, DIM))[0].astype(np.float32)
    cfg = jivf.IVFPQConfig(num_lists=L, pq=jquant.PQConfig(D, K),
                           block_size=BS)
    jindex = jivf.build(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(R),
                        cfg, coarse_iters=5, pq_iters=5)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    return jindex, tindex, X, Q


def test_index_from_numpy_keeps_storage_dtypes(built):
    jindex, tindex, _, _ = built
    assert tindex.codes.dtype == torch.uint8
    assert tindex.ids.dtype == torch.int32
    assert tindex.list_offsets.dtype == torch.int32
    assert tindex.device.type == "cpu"
    assert tindex.capacity == jindex.capacity
    assert tindex.max_list_blocks() == jindex.max_list_blocks()
    np.testing.assert_array_equal(tindex.codes.numpy(),
                                  np.asarray(jindex.codes))
    with pytest.raises(KeyError):
        convert.index_from_numpy({"R": np.eye(2)}, device="cpu")


@pytest.mark.parametrize("nprobe", [1, 4, L])
def test_ivf_search_matches_jax(built, nprobe):
    jindex, tindex, _, Q = built
    want = jsearch.search_fixed(
        jindex, jnp.asarray(Q), nprobe=nprobe, k=10,
        max_blocks=jindex.max_list_blocks(), use_kernel=False)
    ivf = search.make("ivf")
    got = ivf.search(ivf.attach(tindex), _t(Q), k=10, nprobe=nprobe)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.scanned.numpy(),
                                  np.asarray(want.scanned))


def test_ivf_search_matches_jax_kernel(built):
    """One query against the JAX Pallas ivf_adc kernel (interpret mode)."""
    jindex, tindex, _, Q = built
    nprobe = 2
    mb = jindex.max_list_blocks()
    assert nprobe * mb <= 64
    q = Q[:1]
    want = jsearch.search_fixed(jindex, jnp.asarray(q), nprobe=nprobe, k=10,
                                max_blocks=mb, use_kernel=True)
    got = tsearch.search_fixed(tindex, _t(q), nprobe=nprobe, k=10,
                               max_blocks=mb)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("lut_dtype", ["int8", "uint8"])
def test_quantized_lut_search_matches_jax(built, lut_dtype):
    jindex, tindex, _, Q = built
    want = jsearch.search_fixed(
        jindex, jnp.asarray(Q), nprobe=3, k=10,
        max_blocks=jindex.max_list_blocks(), use_kernel=False,
        lut_dtype=lut_dtype)
    got = tsearch.search(tindex, _t(Q), nprobe=3, k=10, lut_dtype=lut_dtype)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def test_nprobe_all_lists_equals_flat_adc(built):
    _, tindex, _, Q = built
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    a = ivf.search(ivf.attach(tindex), _t(Q), k=10, nprobe=L)
    b = flat.search(flat.attach(tindex), _t(Q), k=10)
    assert torch.equal(a.ids, b.ids)
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), atol=1e-4,
                               rtol=0)
    jindex = built[0]
    js, jids = jsearch.flat_adc_scores(jindex, jnp.asarray(Q))
    ts, tids = tsearch.flat_adc_scores(tindex, _t(Q))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(np.isneginf(ts.numpy()),
                                  np.isneginf(np.asarray(js)))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_allclose(ts.numpy()[fin], np.asarray(js)[fin],
                               atol=1e-4, rtol=0)


def test_coarse_scores_do_not_depend_on_batch_size(built, monkeypatch):
    """A query's coarse scores, and so its probe and answer, are the same in
    a batch of any size: the product runs in chunks of PROBE_ROWS rows.
    Here the chunk is 4 rows, so batches of 3, 7 and 16 rows take 1, 2 and
    4 products, the last padded."""
    _, tindex, _, Q = built
    monkeypatch.setattr(tsearch, "PROBE_ROWS", 4)
    QR = _t(Q) @ tindex.R
    full = tsearch.coarse_scores(tindex, QR)
    np.testing.assert_allclose(full.numpy(),
                               (QR @ tindex.centroids.T).numpy(),
                               rtol=1e-6, atol=1e-5)
    for b in (3, 7, 16):
        assert torch.equal(tsearch.coarse_scores(tindex, QR[:b]), full[:b])
    ivf = search.make("ivf")
    state = ivf.attach(tindex)
    whole = ivf.search(state, _t(Q), k=10)
    part = ivf.search(state, _t(Q[:7]), k=10)
    assert torch.equal(part.ids, whole.ids[:7])
    assert torch.equal(part.scores, whole.scores[:7])


def _subspace_delta(jindex, seed: int):
    G = jax.random.normal(jax.random.PRNGKey(seed), (DIM, DIM))
    learner = jrot.make("subspace_gcd", sub=DIM // D)
    _, delta = learner.update(learner.init_from(jindex.R), G, 2e-3,
                              jax.random.PRNGKey(0))
    tdelta = rotations.GivensDelta(pi=_t(delta.pi), pj=_t(delta.pj),
                                   theta=_t(delta.theta))
    return delta, tdelta


def test_refresh_delta_matches_jax(built):
    jindex, tindex, X, _ = built
    jdelta, tdelta = _subspace_delta(jindex, 11)
    want = jmaintain.refresh_delta(jindex, jdelta)
    got = tmaintain.refresh_delta(tindex, tdelta)
    for name in ("R", "centroids", "codebooks"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert got.codes is tindex.codes                   # codes untouched
    assert tmaintain.refresh_mismatch(got, _t(X)) == 0.0
    ivf = search.make("ivf")
    state = ivf.refresh(ivf.attach(tindex), tdelta)
    assert torch.equal(state.index.R, got.R)
    with pytest.raises(TypeError):
        tmaintain.refresh_delta(tindex, object())


def test_refresh_mismatch_counts_stale_codes(built):
    """A cross-subspace delta leaves codes the rebuild would change; the
    port counts the same fraction as the JAX package."""
    jindex, tindex, X, _ = built
    pi, pj = np.array([0, 9, 17]), np.array([8, 30, 3])
    theta = np.array([0.3, -0.25, 0.2], np.float32)
    want = float(jmaintain.refresh_mismatch(
        jmaintain.refresh_rotation(jindex, jnp.asarray(pi), jnp.asarray(pj),
                                   jnp.asarray(theta)), jnp.asarray(X)))
    got = tmaintain.refresh_mismatch(
        tmaintain.refresh_rotation(tindex, _t(pi), _t(pj), _t(theta)), _t(X))
    assert got > 0.0
    assert got == pytest.approx(want, abs=2.0 / N)


def test_encode_matches_jax(built):
    jindex, tindex, X, _ = built
    XR = X @ np.asarray(jindex.R)
    jl, jc = jivf.encode(jnp.asarray(XR), jindex.coarse, jindex.quantizer)
    tl, tc = tivf.encode(_t(XR), tindex.coarse, tindex.quantizer)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_pack_matches_jax():
    rng = np.random.RandomState(4)
    m, L_, bs = 300, 6, 16
    codes = rng.randint(0, K, size=(m, D)).astype(np.int32)
    lists = rng.randint(0, L_ - 1, size=m).astype(np.int32)   # list 5 empty
    ids = rng.permutation(m).astype(np.int32) + 7
    R = np.eye(DIM, dtype=np.float32)
    cents = rng.randn(L_, DIM).astype(np.float32)
    cbs = rng.randn(D, K, DIM // D).astype(np.float32)
    want = jivf.pack(jnp.asarray(R), jquant.VQ(jnp.asarray(cents)),
                     jquant.PQ(jnp.asarray(cbs)), jnp.asarray(codes),
                     jnp.asarray(lists), jnp.asarray(ids), block_size=bs)
    got = tivf.pack(_t(R), quant.VQ(_t(cents)), quant.PQ(_t(cbs)), _t(codes),
                    _t(lists), _t(ids), block_size=bs)
    for name in ("codes", "ids", "list_offsets"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_kmeans_update_matches_jax():
    rng = np.random.RandomState(2)
    X = rng.randn(600, 16).astype(np.float32)
    cb0 = np.transpose(X[rng.choice(600, 8, replace=False)].reshape(8, 4, 4),
                       (1, 0, 2)).copy()
    jcb, jcodes = jkmeans.kmeans_update(jnp.asarray(X), jnp.asarray(cb0))
    tcb, tcodes = tkmeans.kmeans_update(_t(X), _t(cb0))
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), atol=1e-5,
                               rtol=0)
    # assignments exactly, except where two codewords are within rounding
    d2 = ((X.reshape(600, 4, 1, 4) - cb0[None]) ** 2).sum(-1)
    srt = np.sort(d2, axis=-1)
    clear = (srt[..., 1] - srt[..., 0]) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(tcodes.numpy()[clear],
                                  np.asarray(jcodes)[clear])


def test_build_is_a_valid_csr():
    """The end-to-end build on a torch generator draws other random numbers
    than the JAX build, so it is checked by its invariants."""
    g = device.generator(3, "cpu")
    X = synthetic.sift_like(g, 3000, DIM, device="cpu")
    R = rotations.make("gcd_greedy").init(DIM, device="cpu").R
    cfg = search.SearchConfig(num_lists=L, subspaces=D, codewords=K,
                              block_size=BS, train_size=1024)
    state = search.make("ivf").build(g, X, R, cfg, device="cpu")
    index = state.index
    offs = index.list_offsets.numpy()
    assert offs[0] == 0 and np.all(offs % BS == 0) and np.all(np.diff(offs) >= 0)
    assert index.capacity == offs[-1] + BS
    ids = index.ids.numpy()
    assert np.all(ids[-BS:] == -1)                      # sentinel block
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(3000))
    assert index.codes.dtype == torch.uint8
    stats = search.make("ivf").stats(state)
    assert stats["rows"] == 3000 and stats["device"] == "cpu"
    # every row sits in the list the coarse quantizer assigns it
    rows = np.nonzero(ids >= 0)[0]
    row_list = np.searchsorted(offs, rows, side="right") - 1
    lists = index.coarse.assign(X[ids[rows]] @ index.R).numpy()
    np.testing.assert_array_equal(row_list, lists)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        search.make("ivf").build(g, X, R, cfg._replace(depth=2),
                                 device="cpu")


def test_gcd_state_from_numpy_steps_like_jax():
    # a Hadamard R and a dyadic G make A exact in float32 (see
    # test_torch_rotations.py), so both matchings see the same scores
    rng = np.random.RandomState(6)
    H = np.array([[1.0]])
    while H.shape[0] < 16:
        H = np.block([[H, H], [H, -H]])
    R = (H / 4.0).astype(np.float32)
    G = (rng.randint(-4, 5, size=(16, 16)) / 4).astype(np.float32)
    jl = jrot.make("gcd_greedy")
    jstate = jl.init_from(jnp.asarray(R))
    tstate = convert.gcd_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, device="cpu")
    np.testing.assert_array_equal(tstate.R.numpy(), R)
    assert tstate.step.dtype == torch.int32
    jnew, _ = jl.update(jstate, jnp.asarray(G), 1e-2, jax.random.PRNGKey(0))
    tnew, _ = rotations.make("gcd_greedy").update(tstate, _t(G), 1e-2)
    np.testing.assert_allclose(tnew.R.numpy(), np.asarray(jnew.R), atol=1e-6,
                               rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.gcd_state_from_numpy({"R": R, "accum": np.ones_like(R)},
                                     device="cpu")


def test_sift_like_and_recall():
    g = device.generator(0, "cpu")
    X = synthetic.sift_like(g, 500, 16, device="cpu")
    assert X.shape == (500, 16) and X.dtype == torch.float32
    X2 = synthetic.sift_like(device.generator(0, "cpu"), 500, 16,
                             device="cpu")
    assert torch.equal(X, X2)
    assert bool(torch.all(torch.isfinite(X)))
    rng = np.random.RandomState(0)
    truth = np.stack([rng.permutation(50)[:10] for _ in range(8)])
    pred = np.where(rng.rand(8, 10) < 0.3, -1,
                    np.stack([rng.permutation(50)[:10] for _ in range(8)]))
    assert metrics.recall_at_k(_t(pred), _t(truth)) == pytest.approx(
        jmetrics.recall_at_k(pred, truth))
    assert metrics.recall_at_k(pred, truth, k=5) == pytest.approx(
        jmetrics.recall_at_k(pred, truth, k=5))
