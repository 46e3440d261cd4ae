"""The port's row-sharded serving family (``search.sharded``,
``index.ivf.shard_split``/``build_sharded``, ``quant.kmeans``'s sharded fit,
sharded churn and ``shard_rebalance``, ``launch.mesh.make_data_mesh``) on
CPU shards, held to the JAX package's twins.

The JAX twins need several devices, so their references come from one
module-scoped subprocess run with 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set only in the
child, as ``tests/test_distributed.py`` does); it reads the inputs from
and writes its results to npz files in a temporary directory. The port
runs the same states, carried across by ``convert``, on
``make_data_mesh(devices=("cpu",) * 8)``. The sharded k-means is held to
the JAX ``_sharded_lloyd_step`` under ``jax.vmap(axis_name="data")`` on
the stacked shards in this process (no forced devices needed).

Tolerances: scores within 1e-6 of the JAX twins', relative to the
largest |score| of the batch (about 10 here, so about ten float32 ulps:
each package builds its LUTs by its own float32 sums), and ids equal
wherever the gap to the k-th score exceeds that; k-means codebooks
within 1e-5; the churn fields bit-equal on dyadic inputs (every distance exact in float32, so
both packages choose the same lists and codes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import churn, convert, rotations, search
from repro_torch.index import ivf as index_ivf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.quant import PQConfig
from repro_torch.quant import kmeans as km
from repro_torch.search import sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, SUB, K, L, BS = 16, 4, 16, 8, 8
N, B, S = 2000, 16, 8
CFG = dict(num_lists=L, subspaces=SUB, codewords=K, block_size=BS, nprobe=4,
           tile_rows=256)
SMALL = dict(num_lists=2, codewords=8, nprobe=2, tile_rows=8)
TOL = 1e-6
SPLITS = (2, 3, 8)
CHURN_N, CHURN_CAP = 1200, 32
BUILD_ITERS = 1            # coarse k-means iterations of build_sharded: the
                           # JAX sharded fit runs its shard_map op by op
SERVED = (1, 5, 8)         # churn steps whose states are searched too

CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import churn, search
    from repro.index import ivf
    from repro.launch.mesh import make_data_mesh, make_mesh_compat
    from repro import quant

    d = sys.argv[1]
    BUILD_ITERS = int(sys.argv[4])
    SERVED = json.loads(sys.argv[5])
    inp = dict(np.load(os.path.join(d, "in.npz")))
    X, Q, R, Xs = (jnp.asarray(inp[k]) for k in ("X", "Q", "R", "Xs"))
    cfg = search.SearchConfig(**json.loads(sys.argv[2]))
    small = cfg._replace(**json.loads(sys.argv[3]))
    out = {}

    def index_arrays(pre, idx):
        for f in ("codes", "ids", "list_offsets", "R", "centroids",
                  "codebooks"):
            out[pre + f] = np.asarray(getattr(idx, f))

    def sharded_arrays(pre, st):
        for f in ("codes", "ids", "list_offsets", "R"):
            out[pre + f] = np.asarray(getattr(st, f))
        out[pre + "centroids"] = np.asarray(st.coarse.centroids)
        out[pre + "codebooks"] = np.asarray(st.quantizer.codebooks)
        out[pre + "max_blocks"] = np.asarray(st.max_blocks)
        if st.staging is not None:
            for f in ("codes", "ids", "lists"):
                out[pre + "stg_" + f] = np.asarray(getattr(st.staging, f))

    def result(pre, r):
        out[pre + "scores"] = np.asarray(r.scores)
        out[pre + "res_ids"] = np.asarray(r.ids)
        out[pre + "scanned"] = np.asarray(r.scanned)

    mesh = make_data_mesh()
    index = ivf.build(jax.random.PRNGKey(3), X, R, cfg.ivf_config())
    index_arrays("dense_", index)
    sparse = ivf.build(jax.random.PRNGKey(3), X, R, cfg.ivf_config(),
                       ids=jnp.asarray(inp["sparse_ids"]))
    index_arrays("sparse_", sparse)
    for name, idx in (("dense", index), ("sparse", sparse)):
        for n in (2, 3, 8):
            for s, p in enumerate(ivf.shard_split(idx, n)):
                for f in ("codes", "ids", "list_offsets"):
                    out[f"split_{name}_{n}_{s}_{f}"] = np.asarray(
                        getattr(p, f))

    for name in ("flat_sharded", "ivf_sharded"):
        s = search.make(name, mesh=mesh)
        st = s.attach(index, mesh=mesh, nprobe=cfg.nprobe)
        sharded_arrays(name + "_", st)
        result(name + "_", s.search(st, Q, k=10))
        one = s.build(jax.random.PRNGKey(8), Xs, R, small)
        sharded_arrays(name + "_small_", one)
        result(name + "_small_", s.search(one, Xs[:4], k=16))
    s = search.make("exact_sharded", mesh=mesh)
    for pre, xx, c, q, k in (("exact_", X, cfg, Q, 10),
                             ("exact_small_", Xs, small, Xs[:4], 16)):
        st = s.build(jax.random.PRNGKey(3), xx, R, c)
        for f in ("XR", "ids", "R"):
            out[pre + f] = np.asarray(getattr(st, f))
        out[pre + "tile_rows"] = np.asarray(st.tile_rows)
        result(pre, s.search(st, q, k=k))
    pod = make_mesh_compat((2, 4), ("pod", "data"))
    s = search.make("ivf_sharded", mesh=pod)
    st = s.attach(index, mesh=pod, nprobe=cfg.nprobe)
    out["pod_shards"] = np.asarray(s.stats(st)["shards"])
    out["pod_replicated"] = np.asarray(
        st.codes.sharding.is_fully_replicated)
    result("pod_", s.search(st, Q, k=10))

    # build_sharded over 8 chunks, the coarse fit sharded over the mesh
    chunks = [np.asarray(X)[i::8] for i in range(8)]
    parts = ivf.build_sharded(jax.random.PRNGKey(3), chunks, R,
                              cfg.ivf_config(), train_size=1024, mesh=mesh,
                              coarse_iters=BUILD_ITERS)
    st = search.attach_shards(parts, mesh=mesh, nprobe=8)
    for i, p in enumerate(parts):
        out[f"bs_{i}_ids"] = np.asarray(p.ids)
    result("bs_", search.make("ivf_sharded").search(st, Q, k=10, nprobe=8))

    # churn on a dyadic index (exact distances): the ops' stacked fields
    coarse = quant.VQ(centroids=jnp.asarray(inp["dy_cent"]))
    pq = quant.PQ(codebooks=jnp.asarray(inp["dy_cb"]))
    DR = jnp.asarray(inp["dy_R"])
    lists, codes = ivf.encode(jnp.asarray(inp["dy_X"]) @ DR, coarse, pq)
    dy = ivf.pack(DR, coarse, pq, codes, lists,
                  jnp.arange(inp["dy_X"].shape[0], dtype=jnp.int32),
                  block_size=cfg.block_size)
    index_arrays("dy_", dy)
    st = search.IVFSharded.attach(dy, mesh=mesh, nprobe=cfg.num_lists)
    adds, nid = inp["dy_adds"], int(inp["dy_X"].shape[0])
    ops = [("with_staging",), ("stage", 0, 40), ("flush",),
           ("tombstone", inp["dy_remove"]), ("stage", 40, 70),
           ("compact",), ("tombstone", inp["dy_remove2"]),
           ("stage", 70, 90), ("rebalance",)]
    for i, op in enumerate(ops):
        if op[0] == "with_staging":
            st = churn.with_staging(st, int(inp["dy_cap"]))
        elif op[0] == "stage":
            st = churn.stage(st, jnp.asarray(adds[op[1]:op[2]]),
                             np.arange(nid + op[1], nid + op[2]))
        elif op[0] == "flush":
            st, moved = churn.flush(st)
            out[f"churn_{i}_moved"] = np.asarray(moved)
        elif op[0] == "tombstone":
            st = churn.tombstone(st, op[1])
        elif op[0] == "compact":
            st = churn.compact(st)
        else:
            st = churn.shard_rebalance(st)
        sharded_arrays(f"churn_{i}_", st)
        if i in SERVED:
            result(f"churn_{i}_", search.make("ivf_sharded").search(
                st, jnp.asarray(adds[:8]), k=10))
    np.savez(os.path.join(d, "out.npz"), **out)
    print(json.dumps({"devices": jax.device_count()}))
""")


def _dyadic_inputs() -> dict:
    """Dyadic churn inputs: R a signed permutation, centroids on a grid of
    1/2, codebooks and vectors on a grid of 1/4 (as test_torch_churn)."""
    rng = np.random.RandomState(5)
    R = np.eye(DIM, dtype=np.float32)[rng.permutation(DIM)] * np.where(
        rng.rand(DIM) < 0.5, -1.0, 1.0).astype(np.float32)[:, None]
    return dict(
        dy_R=R, dy_cent=(rng.randint(-4, 5, (L, DIM)) / 2).astype(np.float32),
        dy_cb=(rng.randint(-4, 5, (SUB, K, DIM // SUB)) / 4
               ).astype(np.float32),
        dy_X=(rng.randint(-8, 9, (CHURN_N, DIM)) / 4).astype(np.float32),
        dy_adds=(rng.randint(-8, 9, (90, DIM)) / 4).astype(np.float32),
        # the first 300 ids live in shards 0-1 of 8: the rebalance moves rows
        dy_remove=np.concatenate([np.arange(0, 300), [CHURN_N + 3]]),
        dy_remove2=np.arange(300, 360), dy_cap=np.asarray(CHURN_CAP))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX twins' results on 8 forced host devices (module docstring),
    and the numpy inputs both packages read."""
    d = str(tmp_path_factory.mktemp("sharded_ref"))
    rng = np.random.RandomState(0)
    X = rng.randn(N, DIM).astype(np.float32)
    Q = rng.randn(B, DIM).astype(np.float32)
    R = np.linalg.qr(rng.randn(DIM, DIM))[0].astype(np.float32)
    inp = dict(X=X, Q=Q, R=R, Xs=rng.randn(50, DIM).astype(np.float32),
               sparse_ids=(np.arange(N) * 7 + 1000).astype(np.int32)[
                   rng.permutation(N)], **_dyadic_inputs())
    np.savez(os.path.join(d, "in.npz"), **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", CHILD, d, json.dumps(CFG), json.dumps(SMALL),
         str(BUILD_ITERS), json.dumps(SERVED)],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert json.loads(run.stdout.splitlines()[-1])["devices"] == 8
    out = dict(np.load(os.path.join(d, "out.npz")))
    return inp, out


def _stacked(tensors) -> np.ndarray:
    """Per-shard tensors as the JAX package's stacked (S, ...) array."""
    return np.stack([t.numpy() for t in tensors])


def _cpu_mesh(n: int = S):
    return mesh_lib.make_data_mesh(devices=("cpu",) * n)


def _index(out: dict, pre: str):
    return convert.index_from_numpy(dict(
        R=out[pre + "R"], centroids=out[pre + "centroids"],
        codebooks=out[pre + "codebooks"], codes=out[pre + "codes"],
        ids=out[pre + "ids"], list_offsets=out[pre + "list_offsets"],
        block_size=BS), device="cpu")


def _sharded_state(out: dict, pre: str, mesh, nprobe: int):
    arrays = {k: out[pre + k] for k in ("R", "centroids", "codebooks",
                                         "codes", "ids", "list_offsets")}
    arrays["block_size"] = BS
    return convert.sharded_adc_state_from_numpy(
        arrays, mesh=mesh, fused=False, nprobe=nprobe,
        max_blocks=int(out[pre + "max_blocks"]))


def _hold_result(got, out: dict, pre: str) -> None:
    """Scores within TOL of the JAX twin's, relative to the scores' scale;
    ids equal wherever the score is more than that from the k-th (a near
    tie may order either way)."""
    want_s, want_i = out[pre + "scores"], out[pre + "res_ids"]
    got_s, got_i = got.scores.numpy(), got.ids.numpy()
    assert got_s.shape == want_s.shape
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    tol = TOL * max(1.0, float(np.abs(want_s[fin]).max(initial=0.0)))
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=0, atol=tol)
    kth = np.where(fin, want_s, np.inf).min(axis=1, keepdims=True)
    clear = ~fin | (np.abs(want_s - kth) > tol)
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    np.testing.assert_array_equal(got.scanned.numpy(), out[pre + "scanned"])


def _hold_state(t, out: dict, pre: str) -> None:
    for f in ("codes", "ids", "list_offsets"):
        np.testing.assert_array_equal(
            _stacked(getattr(t, f)), out[pre + f], err_msg=pre + f)
    if t.staging is not None:
        for f in ("codes", "ids", "lists"):
            np.testing.assert_array_equal(
                _stacked([getattr(b, f) for b in t.staging]),
                out[pre + "stg_" + f], err_msg=pre + "stg_" + f)
    assert t.max_blocks == int(out[pre + "max_blocks"]), pre


# -- (a) shard_split ----------------------------------------------------------


@pytest.mark.parametrize("ids", ["dense", "sparse"])
@pytest.mark.parametrize("n", SPLITS)
def test_shard_split_bit_equal_to_jax(ref, ids, n):
    _, out = ref
    parts = index_ivf.shard_split(_index(out, f"{ids}_"), n)
    assert len(parts) == n
    for s, p in enumerate(parts):
        for f in ("codes", "ids", "list_offsets"):
            np.testing.assert_array_equal(
                getattr(p, f).numpy(), out[f"split_{ids}_{n}_{s}_{f}"],
                err_msg=f"shard {s} {f}")
    live = np.concatenate([p.ids.numpy() for p in parts])
    assert sorted(live[live >= 0]) == sorted(
        out[f"{ids}_ids"][out[f"{ids}_ids"] >= 0])
    sizes = [int((p.ids >= 0).sum()) for p in parts]
    assert max(sizes) - min(sizes) <= 1


# -- (b) the three twins on 8 CPU shards -------------------------------------


@pytest.mark.parametrize("backend", ["flat_sharded", "ivf_sharded"])
def test_adc_twins_match_jax(ref, backend):
    """attach of the JAX index over 8 CPU shards equals the JAX twin's
    stacked state bit for bit, and serves its results."""
    _, out = ref
    mesh = _cpu_mesh()
    s = search.make(backend, mesh=mesh)
    state = s.attach(_index(out, "dense_"), mesh=mesh, nprobe=CFG["nprobe"])
    _hold_state(state, out, f"{backend}_")
    assert s.stats(state)["shards"] == S
    _hold_result(s.search(state, torch.from_numpy(ref[0]["Q"]), k=10),
                 out, f"{backend}_")
    carried = _sharded_state(out, f"{backend}_", mesh, CFG["nprobe"])
    _hold_result(s.search(carried, torch.from_numpy(ref[0]["Q"]), k=10),
                 out, f"{backend}_")


@pytest.mark.parametrize("backend", ["flat_sharded", "ivf_sharded"])
def test_adc_twins_k_above_shard_pool(ref, backend):
    """50 rows over 8 shards at k = 16: every shard's run is padded with
    (−inf, −1), and the merge keeps the contract."""
    inp, out = ref
    mesh = _cpu_mesh()
    s = search.make(backend, mesh=mesh)
    state = _sharded_state(out, f"{backend}_small_", mesh, SMALL["nprobe"])
    res = s.search(state, torch.from_numpy(inp["Xs"][:4]), k=16)
    _hold_result(res, out, f"{backend}_small_")
    sc, ids = res.scores.numpy(), res.ids.numpy()
    assert ids.shape == (4, 16)
    assert np.all(np.isneginf(sc[ids < 0])) and np.all(
        np.isfinite(sc[ids >= 0]))
    assert np.all(np.diff(sc, axis=1) <= 1e-6)


@pytest.mark.parametrize("small", [False, True])
def test_exact_sharded_matches_jax(ref, small):
    """The build's slices and ids equal the JAX twin's (XR within float32
    rounding), and the twin's own state serves its results."""
    inp, out = ref
    pre = "exact_small_" if small else "exact_"
    mesh = _cpu_mesh()
    s = search.make("exact_sharded", mesh=mesh)
    cfg = search.SearchConfig(**CFG)
    if small:
        cfg = cfg._replace(**SMALL)
    X = inp["Xs"] if small else inp["X"]
    built = s.build(None, torch.from_numpy(X), torch.from_numpy(inp["R"]),
                    cfg)
    np.testing.assert_array_equal(_stacked(built.ids), out[pre + "ids"])
    np.testing.assert_allclose(_stacked(built.XR), out[pre + "XR"],
                               rtol=0, atol=1e-5)
    assert built.tile_rows == int(out[pre + "tile_rows"])
    carried = convert.sharded_exact_state_from_numpy(
        dict(R=out[pre + "R"], XR=out[pre + "XR"], ids=out[pre + "ids"],
             tile_rows=out[pre + "tile_rows"]), mesh=mesh)
    q = inp["Xs"][:4] if small else inp["Q"]
    _hold_result(s.search(carried, torch.from_numpy(q), k=16 if small
                          else 10), out, pre)


def test_sharded_twins_equal_single_device(ref):
    """On one state the sharded twins return the replicated backends'
    results: bit-equal scores and ids."""
    inp, out = ref
    mesh = _cpu_mesh()
    index = _index(out, "dense_")
    Q = torch.from_numpy(inp["Q"])
    for name, single in (("flat_sharded", "flat_adc"), ("ivf_sharded", "ivf")):
        st = search.make(name).attach(index, mesh=mesh, nprobe=4)
        got = search.make(name).search(st, Q, k=10)
        want = search.make(single)
        wst = (want.attach(index, nprobe=4) if single == "ivf"
               else want.attach(index))
        w = want.search(wst, Q, k=10)
        assert torch.equal(got.scores, w.scores) and torch.equal(got.ids,
                                                                  w.ids)
    ex = search.make("exact_sharded", mesh=mesh)
    cfg = search.SearchConfig(**CFG)
    got = ex.search(ex.build(None, torch.from_numpy(inp["X"]),
                             torch.from_numpy(inp["R"]), cfg), Q, k=10)
    e = search.make("exact")
    w = e.search(e.build(None, torch.from_numpy(inp["X"]),
                         torch.from_numpy(inp["R"]), cfg, device="cpu"), Q,
                 k=10)
    assert torch.equal(got.ids, w.ids)
    torch.testing.assert_close(got.scores, w.scores, rtol=0, atol=1e-5)


def test_pod_data_mesh_shards_eight_ways(ref):
    """A (2, 4) ("pod", "data") mesh shards over the full product of the
    row axes: 8 shards, as the JAX twin (which does not replicate)."""
    inp, out = ref
    assert int(out["pod_shards"]) == 8 and not bool(out["pod_replicated"])
    pod = mesh_lib.make_mesh_compat((2, 4), ("pod", "data"),
                                    devices=("cpu",) * 8)
    assert sharded.resolve_axes(pod) == ("pod", "data")
    s = search.make("ivf_sharded", mesh=pod)
    st = s.attach(_index(out, "dense_"), mesh=pod, nprobe=4)
    assert s.stats(st)["shards"] == 8
    _hold_result(s.search(st, torch.from_numpy(inp["Q"]), k=10), out, "pod_")
    with pytest.raises(ValueError, match="shard over all"):
        s.attach(_index(out, "dense_"), mesh=pod, axis="data")


# -- (c) attach_shards refuses parts of different fits -----------------------


@pytest.mark.parametrize("field", ["R", "coarse", "quantizer", "block_size"])
def test_attach_shards_rejects_mismatched_parts(ref, field):
    _, out = ref
    parts = index_ivf.shard_split(_index(out, "dense_"), 2)
    p = parts[1]
    rogue = {
        "R": lambda: dataclasses.replace(p, R=-p.R),
        "coarse": lambda: dataclasses.replace(p, coarse=type(p.coarse)(
            p.coarse.centroids + 1.0)),
        "quantizer": lambda: dataclasses.replace(
            p, quantizer=type(p.quantizer)(p.quantizer.codebooks * 2.0)),
        "block_size": lambda: dataclasses.replace(p, block_size=2 * BS),
    }[field]()
    mesh = _cpu_mesh(2)
    search.attach_shards(parts, mesh=mesh)          # the shared fit serves
    with pytest.raises(ValueError, match="does not share shard 0"):
        search.attach_shards([parts[0], rogue], mesh=mesh)


# -- (d) the sharded k-means --------------------------------------------------


def test_kmeans_sharded_matches_jax_lloyd_step():
    """Every iteration of ``kmeans_sharded`` against the JAX
    ``_sharded_lloyd_step`` under ``jax.vmap(axis_name="data")`` on the
    same stacked, zero-weight-padded shards from the same init."""
    from repro.quant import kmeans as jkm

    rng = np.random.RandomState(1)
    X = rng.randn(1027, DIM).astype(np.float32)          # ragged over 8
    cfg, iters = PQConfig(2, 16), 3
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    cb = km.kmeans_init(g, torch.from_numpy(X), cfg).numpy()
    pad = (-X.shape[0]) % S
    Xp = np.concatenate([X, np.zeros((pad, DIM), np.float32)])
    w = np.concatenate([np.ones(X.shape[0], np.float32),
                        np.zeros(pad, np.float32)])
    step = jax.vmap(lambda c, x, ww: jkm._sharded_lloyd_step(c, x, ww,
                                                             "data"),
                    in_axes=(None, 0, 0), out_axes=0, axis_name="data")
    want = jnp.asarray(cb)
    for _ in range(iters):
        want = step(want, jnp.asarray(Xp.reshape(S, -1, DIM)),
                    jnp.asarray(w.reshape(S, -1)))[0]
    g.set_state(state)
    got = km.kmeans_sharded(g, torch.from_numpy(X), cfg, mesh=_cpu_mesh(),
                            iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_vq_kmeans_sharded_distortion_and_determinism():
    """The JAX test's bound (distortion within 1.05 of the single-device
    fit's from the same seed) and one fit a seed."""
    X = torch.from_numpy(np.random.RandomState(0).randn(
        1027, DIM).astype(np.float32))

    def distortion(cb):
        return float(torch.cdist(X, cb).pow(2).min(dim=1).values.mean())

    single = km.vq_kmeans(torch.Generator().manual_seed(7), X, 16, iters=8)
    fits = [km.vq_kmeans_sharded(torch.Generator().manual_seed(7), X, 16,
                                 mesh=_cpu_mesh(), iters=8) for _ in range(2)]
    assert fits[0].shape == (16, DIM)
    assert torch.equal(fits[0], fits[1])
    assert distortion(fits[0]) <= distortion(single) * 1.05


# -- (e) build_sharded ----------------------------------------------------------


def test_build_sharded_against_jax(ref):
    """Eight chunks of the corpus: each part holds its chunk's global ids
    in chunk order, as the JAX build's parts do, and the attached state's
    recall@10 is within the JAX test's 0.15 of the JAX build's (the fits
    draw from different generators)."""
    inp, out = ref
    from repro_torch.metrics import recall_at_k

    X, Q = inp["X"], inp["Q"]
    chunks = [X[i::8] for i in range(8)]
    mesh = _cpu_mesh()
    cfg = search.SearchConfig(**CFG)
    parts = index_ivf.build_sharded(
        torch.Generator().manual_seed(3), chunks, torch.from_numpy(inp["R"]),
        cfg.ivf_config(), train_size=1024, mesh=mesh, device="cpu",
        coarse_iters=BUILD_ITERS)
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(np.sort(p.ids.numpy()[p.ids >= 0]),
                                      np.sort(out[f"bs_{i}_ids"][
                                          out[f"bs_{i}_ids"] >= 0]))
    state = search.attach_shards(parts, mesh=mesh, nprobe=8)
    assert search.make("ivf_sharded").stats(state)["rows"] == N
    order = np.concatenate([np.arange(N)[i::8] for i in range(8)])
    truth = np.argsort(-(Q @ X.T), axis=1)[:, :10]

    def remap(ids):
        return np.where(ids >= 0, order[np.clip(ids, 0, N - 1)], -1)

    got = search.make("ivf_sharded").search(state, torch.from_numpy(Q), k=10,
                                            nprobe=8)
    r_port = recall_at_k(remap(got.ids.numpy()), truth)
    r_jax = recall_at_k(remap(out["bs_res_ids"]), truth)
    assert abs(r_port - r_jax) <= 0.15, (r_port, r_jax)


# -- (f) the Engine over ivf_sharded -----------------------------------------


def test_engine_over_ivf_sharded_refresh_keeps_executables(ref):
    """One executable per (bucket, k, nprobe), a GCD refresh that adds
    none, scores that stay put, and results equal to direct sharded
    searches after the refresh (the JAX test's
    ``test_sharded_engine_refresh_without_recompile``)."""
    inp, out = ref
    mesh = _cpu_mesh()
    s = search.make("ivf_sharded", mesh=mesh)
    for fused in (False, True):
        state = s.attach(_index(out, "dense_"), mesh=mesh, nprobe=4,
                         fused_refresh=fused)
        engine = search.Engine(s, state, k=10, nprobe=4, min_bucket=4)
        Q = inp["Q"]
        for b in (3, 4, 7, 3):
            engine.search(Q[:b])
        compiles = engine.stats()["compiles"]
        assert compiles == 2                           # buckets {4, 8}
        before = engine.search(Q[:8])
        G = torch.from_numpy(np.random.RandomState(9).randn(
            DIM, DIM).astype(np.float32))
        learner = rotations.make("subspace_gcd", sub=DIM // SUB)
        _, delta = learner.update(
            learner.init_from(torch.from_numpy(inp["R"])), G, 1e-3)
        engine.refresh(delta)
        after = engine.search(Q[:8])
        st = engine.stats()
        assert st["compiles"] == compiles and st["refreshes"] == 1
        torch.testing.assert_close(after.scores, before.scores, rtol=0,
                                   atol=1e-4)
        direct = s.search(engine.state, torch.from_numpy(Q[:8]), k=10,
                          nprobe=4)
        assert torch.equal(after.ids, direct.ids)
        if fused:
            # the cache keeps the tables of before the within-subspace
            # refresh, equal to the new ones in exact arithmetic
            torch.testing.assert_close(after.scores, direct.scores, rtol=0,
                                       atol=1e-5)
        else:
            assert torch.equal(after.scores, direct.scores)
        assert st["lut_invalidations"] == (0 if fused else 1)


# -- (g) sharded churn ----------------------------------------------------------


def test_sharded_churn_ops_bit_equal_to_jax(ref):
    """with_staging → stage → flush → tombstone → stage → compact →
    tombstone → stage → shard_rebalance on 8 shards of a dyadic index: the
    stacked CSR and staging fields equal the JAX ops' after every step,
    and so does what the states after the first stage, the compaction and
    the rebalance serve."""
    inp, out = ref
    mesh = _cpu_mesh()
    s = search.make("ivf_sharded", mesh=mesh)
    st = s.attach(_index(out, "dy_"), mesh=mesh, nprobe=L)
    adds, nid = inp["dy_adds"], CHURN_N
    ops = [("with_staging",), ("stage", 0, 40), ("flush",),
           ("tombstone", inp["dy_remove"]), ("stage", 40, 70),
           ("compact",), ("tombstone", inp["dy_remove2"]),
           ("stage", 70, 90), ("rebalance",)]
    for i, op in enumerate(ops):
        if op[0] == "with_staging":
            st = churn.with_staging(st, CHURN_CAP)
        elif op[0] == "stage":
            st = churn.stage(st, adds[op[1]:op[2]],
                             np.arange(nid + op[1], nid + op[2]))
        elif op[0] == "flush":
            st, moved = churn.flush(st)
            assert moved == int(out[f"churn_{i}_moved"])
        elif op[0] == "tombstone":
            st = churn.tombstone(st, op[1])
        elif op[0] == "compact":
            st = churn.compact(st)
        else:
            st = churn.shard_rebalance(st)
        _hold_state(st, out, f"churn_{i}_")
        if i in SERVED:
            _hold_result(s.search(st, torch.from_numpy(adds[:8]), k=10),
                         out, f"churn_{i}_")
    rows = churn.shard_rows(st)
    assert max(rows) - min(rows) <= 1
    assert churn.live_rows(st) == CHURN_N - 360 + 90 - 1


def test_maybe_rebalance_fires_at_the_threshold(ref):
    """The controller rebalances when the largest shard's live rows
    (staged counted) exceed the mean by the threshold, once, and the top-k
    of the live set is the same before and after."""
    inp, out = ref
    mesh = _cpu_mesh(4)
    s = search.make("ivf_sharded", mesh=mesh)
    state = s.attach(_index(out, "dense_"), mesh=mesh, nprobe=L)
    engine = search.Engine(s, state, k=10, nprobe=L, min_bucket=16)
    ctl = churn.ChurnController(engine, staging_rows=64,
                                imbalance_threshold=1.03, compact_at=1.0)
    assert not ctl.maybe_rebalance()
    # tombstone the high end: shard 3's rows go first, so it falls behind
    ctl.remove(np.arange(N - 30, N))     # max/mean = 500 / 492.5 < 1.03
    assert not ctl.maybe_rebalance()
    ctl.remove(np.arange(N - 120, N - 30))     # 500 / 470 > 1.03
    Q = torch.from_numpy(inp["Q"])
    before = engine.search(Q)
    assert ctl.maybe_rebalance()
    after = engine.search(Q)
    assert torch.equal(before.ids, after.ids)
    assert torch.equal(before.scores, after.scores)
    assert engine.stats()["churn"]["rebalances"] == 1
    rows = churn.shard_rows(ctl.state)
    assert max(rows) - min(rows) <= 1 and sum(rows) == N - 120
    assert not ctl.maybe_rebalance()


def test_sharded_exact_tombstone(ref):
    inp, _ = ref
    mesh = _cpu_mesh(4)
    ex = search.make("exact_sharded", mesh=mesh)
    st = ex.build(None, torch.from_numpy(inp["X"]),
                  torch.from_numpy(inp["R"]), search.SearchConfig(**CFG))
    st2 = churn.tombstone(st, np.arange(0, 600))
    assert churn.live_rows(st2) == N - 600
    res = ex.search(st2, torch.from_numpy(inp["Q"]), k=10)
    assert not np.isin(res.ids.numpy(), np.arange(600)).any()
    assert int(res.scanned[0]) == N - 600


# -- (h) the data mesh -------------------------------------------------------------


def test_make_data_mesh_raises_without_enough_cards(monkeypatch):
    """Shards beyond the visible cards raise unless the devices are named;
    named devices give one shard each; no card at all raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_data_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"devices=\('cuda:0',\) \* 4"):
        mesh_lib.make_data_mesh(4)
    assert mesh_lib.make_data_mesh(1).devices == (torch.device("cuda", 0),)
    # a build's device names the mesh's first card with or without its index
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = mesh_lib.make_data_mesh(devices=("cuda",) * 2)
    assert card.devices == (torch.device("cuda", 0),) * 2
    for name in ("cuda", "cuda:0"):
        sharded._check_device(card, name)
    with pytest.raises(ValueError, match="runs on its mesh"):
        sharded._check_device(card, "cpu")
    monkeypatch.undo()
    m = mesh_lib.make_data_mesh(devices=("cpu",) * 4)
    assert m.shape == {"data": 4} and len(m.devices) == 4
    with pytest.raises(ValueError, match="named devices"):
        mesh_lib.make_data_mesh(3, devices=("cpu",) * 4)
    with pytest.raises(ValueError, match="shard over all"):
        sharded.attach_shards([], mesh=mesh_lib.make_mesh_compat(
            (2, 2), ("data", "model"), devices=("cpu",) * 4))
