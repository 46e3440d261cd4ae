"""The port's GraphSAGE slice (``repro_torch.data.graph``,
``repro_torch.models.gnn``, ``repro_torch.bench.gnn_index``) against the JAX
package on the CPU, at the ``make_smoke`` width (d_in 32, d_hidden 16, two
layers, 7 classes).

The graph, its edge list, the sampled blocks and the padded adjacency must
equal the JAX package's bit for bit (both draw from numpy's
``RandomState`` in one order). The JAX parameters are carried across with
``convert.graphsage_params_from_numpy``. Tolerances: logits, embeddings,
losses and every leaf's gradient within 1e-5 of the largest entry
(float32 sums of a few hundred messages in another order: XLA's scatter
against a sorted ``segment_reduce``); an empty segment under ``max`` is
−inf in both, and the NaN it turns into through ``_sage_layer`` sits at
the same places.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import graphsage_reddit as jsage
from repro.data import graph as jgraph
from repro.models import gnn as jgnn
from repro.training import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.bench import gnn_index
from repro_torch.data import graph
from repro_torch.models import gnn
from repro_torch.training import optimizer as opt_lib

JCFG = jsage.make_smoke()
TCFG = configs.get("graphsage-reddit").make_smoke()
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one machine."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rel: float = REL) -> None:
    """|got − want| ≤ rel · max|want| elementwise, NaN where NaN."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    scale = max(float(np.max(np.abs(want[fin]))) if fin.any() else 0.0,
                1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jopt.path_key(p): np.asarray(v) for p, v in leaves}


def _cfgs(aggregator: str):
    return (JCFG._replace(aggregator=aggregator),
            TCFG._replace(aggregator=aggregator))


@pytest.fixture(scope="module")
def params():
    jp = jgnn.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.graphsage_params_from_numpy(_flat(jp), TCFG,
                                                   device="cpu")


def _grads_close(model, loss, jgrads) -> None:
    named = opt_lib.named_leaves(model)
    grads = torch.autograd.grad(loss, list(named.values()))
    want = _flat(jgrads)
    assert set(named) == set(want)
    for (k, _), g in zip(named.items(), grads):
        _close(g, want[k])


# -- the graph substrate ------------------------------------------------------


@pytest.mark.parametrize("args", [(0, 2000, 8, 32, 41), (1, 3000, 20, 16, 8),
                                  (5, 500, 3, 4, 3), (7, 64, 2, 3, 41)])
def test_synthetic_graph_bit_equal(args):
    want = jgraph.synthetic_graph(*args)
    got = graph.synthetic_graph(*args)
    for name, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for a, b in zip(want.edge_list(), got.edge_list()):
        np.testing.assert_array_equal(b, a)
    assert got.num_nodes == want.num_nodes
    assert got.num_edges == want.num_edges


def _isolated_graph() -> tuple:
    """A 6-node CSR graph whose nodes 2 and 5 (the last) have no
    neighbour, in both packages' types."""
    indptr = np.array([0, 2, 3, 3, 6, 8, 8], np.int64)
    indices = np.array([1, 3, 0, 0, 1, 4, 3, 0], np.int32)
    feats = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    labels = np.arange(6, dtype=np.int32) % 3
    return (jgraph.CSRGraph(indptr, indices, feats, labels),
            graph.CSRGraph(indptr, indices, feats, labels))


def test_sample_neighbors_np_isolated_self_loop():
    """Isolated nodes (one of them the last row, where the JAX sampler's
    gather would index past the edges) sample themselves; the rest equal
    the JAX sampler's draws."""
    jg, tg = _isolated_graph()
    nodes = np.array([0, 1, 2, 3, 4, 2, 0])
    got = graph.sample_neighbors_np(tg, np.append(nodes, 5), 5,
                                    np.random.RandomState(3))
    assert got.dtype == np.int32 and got.shape == (8, 5)
    assert np.all(got[[2, 5]] == 2) and np.all(got[7] == 5)
    want = jgraph.sample_neighbors_np(jg, nodes, 5, np.random.RandomState(3))
    np.testing.assert_array_equal(got[:7], want)
    for v, row in zip(nodes, got):
        nbrs = tg.indices[tg.indptr[v]:tg.indptr[v + 1]]
        assert set(row.tolist()) <= (set(nbrs.tolist()) or {v})


def test_sample_blocks_bit_equal():
    """Blocks and labels, gathered from the features on their device,
    equal the JAX package's."""
    g = graph.synthetic_graph(0, 300, 6, 32, num_classes=7)
    jg = jgraph.synthetic_graph(0, 300, 6, 32, num_classes=7)
    seeds = np.random.RandomState(1).randint(0, 300, size=16)
    jf, jl = jgraph.sample_blocks(jg, seeds, (5, 3), seed=4)
    tf, tl = graph.sample_blocks(g, seeds, (5, 3), 4,
                                 torch.from_numpy(g.feats))
    assert [tuple(f.shape) for f in tf] == [(16, 32), (16, 5, 32),
                                            (16, 5, 3, 32)]
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tl.dtype == torch.int64
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_padded_adjacency_bit_equal_and_device_sampler():
    g = graph.synthetic_graph(2, 400, 10, 4)
    jg = jgraph.synthetic_graph(2, 400, 10, 4)
    jadj, jdeg = jgraph.padded_adjacency(jg, 12)
    adj, deg = graph.padded_adjacency(g, 12, device="cpu")
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    _, tg = _isolated_graph()
    adj, deg = graph.padded_adjacency(tg, 3, device="cpu")
    nodes = torch.tensor([[0, 2], [3, 5]])
    gen = torch.Generator().manual_seed(0)
    out = graph.sample_neighbors(gen, adj, deg, nodes, 64)
    assert out.shape == (2, 2, 64) and out.dtype == torch.int64
    for v, row in zip(nodes.reshape(-1).tolist(), out.reshape(4, 64)):
        row_adj = adj[v, :deg[v]].tolist() or [v]
        assert set(row.tolist()) == set(row_adj)   # 64 draws hit every one
    again = graph.sample_neighbors(torch.Generator().manual_seed(0), adj,
                                   deg, nodes, 64)
    assert torch.equal(out, again)


def test_csr_blocks_cover_rows():
    indptr = np.array([0, 3, 3, 10, 11, 12, 20])
    blocks = gnn.csr_blocks(indptr, 4)
    assert blocks[0][0] == 0 and blocks[-1][1] == 6
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for r0, r1 in blocks:
        assert r1 == r0 + 1 or indptr[r1] - indptr[r0] <= 4


# -- the model ----------------------------------------------------------------


def test_convert_keeps_jax_leaf_names(params):
    jp, model = params
    assert set(opt_lib.named_leaves(model)) == set(_flat(jp))
    assert model.layer1.w_neigh.shape == (16, 16)
    bad = _flat(jp)
    del bad["layer0/b"]
    with pytest.raises(KeyError):
        convert.graphsage_params_from_numpy(bad, TCFG, device="cpu")
    bad = _flat(jp)
    bad["classifier"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        convert.graphsage_params_from_numpy(bad, TCFG, device="cpu")


def _random_edges(N: int, E: int, seed: int):
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, JCFG.d_in).astype(np.float32)
    src = rng.randint(0, N, E).astype(np.int32)
    dst = rng.randint(0, N, E).astype(np.int32)
    return feats, src, dst


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_full_batch_forward_and_loss_match_jax(params, aggregator):
    jcfg, tcfg = _cfgs(aggregator)
    jp, model = params
    N = 60
    feats, src, dst = _random_edges(N, 400, 1)
    dst[dst == 7] = 8                       # node 7: no in-edge
    labels = np.random.RandomState(2).randint(0, 7, N).astype(np.int32)
    mask = np.random.RandomState(3).rand(N) < 0.5
    jlogits = jgnn.full_batch_forward(jp, jnp.asarray(feats), src, dst, jcfg)
    logits = gnn.full_batch_forward(model, _t(feats), _t(src), _t(dst), tcfg)
    _close(logits, jlogits)
    assert bool(torch.isnan(logits[7]).any()) == (aggregator == "max")

    # the loss on the graph with a self-loop at 7 (a NaN row would make
    # the masked sum NaN in both packages)
    src, dst = np.append(src, 7).astype(np.int32), np.append(dst, 7)

    def jloss(p):
        return jgnn.loss_full_batch(p, jnp.asarray(feats), src, dst,
                                    labels, mask, jcfg)

    jl, jg = jax.value_and_grad(jloss)(jp)
    loss = gnn.loss_full_batch(model, _t(feats), _t(src), _t(dst),
                               _t(labels), _t(mask), tcfg)
    assert bool(torch.isfinite(loss))
    _close(loss, jl)
    _grads_close(model, loss, jg)


def test_empty_segment_max_is_neg_inf_through_the_layer(params):
    """A node with no in-edge: −inf under segment max in both packages,
    and the same NaN/inf pattern after ``_sage_layer``; 0 under mean."""
    jp, model = params
    feats, src, dst = _random_edges(10, 30, 4)
    dst[dst == 3] = 4
    h, jh = _t(feats), jnp.asarray(feats)
    for agg in ("max", "mean"):
        want = jgnn._aggregate_edges(jh, src, dst, 10, agg)
        got = gnn._aggregate_edges(h, _t(src), _t(dst), 10, agg)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        _close(got, want)
        jout = jgnn._sage_layer(jp["layer0"], jh, want)
        out = gnn._sage_layer(model.layer0, h, got)
        np.testing.assert_array_equal(np.isnan(out.detach().numpy()),
                                      np.isnan(np.asarray(jout)))
        _close(out, jout)
    assert bool(torch.all(torch.isneginf(
        gnn._aggregate_edges(h, _t(src), _t(dst), 10, "max")[3])))


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_minibatch_loss_and_embeddings_match_jax(params, aggregator):
    jcfg, tcfg = _cfgs(aggregator)
    jp, model = params
    jg = jgraph.synthetic_graph(0, 300, 6, 32, num_classes=7)
    tg = graph.synthetic_graph(0, 300, 6, 32, num_classes=7)
    seeds = np.arange(16)
    jf, jl = jgraph.sample_blocks(jg, seeds, jcfg.sample_sizes, seed=1)
    tf, tl = graph.sample_blocks(tg, seeds, tcfg.sample_sizes, 1,
                                 torch.from_numpy(tg.feats))
    _close(gnn.node_embeddings_minibatch(model, tf, tcfg),
           jgnn.node_embeddings_minibatch(jp, jf, jcfg))
    want, jgr = jax.value_and_grad(
        lambda p: jgnn.loss_minibatch(p, jf, jl, jcfg))(jp)
    loss = gnn.loss_minibatch(model, tf, tl, tcfg)
    _close(loss, want)
    _grads_close(model, loss, jgr)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_graph_batch_loss_matches_jax(params, aggregator):
    """The molecule mode: 4 graphs of 15 nodes, mean-pooled."""
    jcfg, tcfg = _cfgs(aggregator)
    jp, model = params
    rng = np.random.RandomState(5)
    feats = rng.randn(60, JCFG.d_in).astype(np.float32)
    gid = np.repeat(np.arange(4), 15).astype(np.int32)
    local = rng.randint(0, 15, (2, 4, 40))
    src = (local[0] + 15 * np.arange(4)[:, None]).reshape(-1).astype(np.int32)
    dst = (local[1] + 15 * np.arange(4)[:, None]).reshape(-1).astype(np.int32)
    dst[np.isin(dst, [3, 31])] = 4           # two nodes with no in-edge
    if aggregator == "max":                  # ... their rows would be NaN
        src, dst = np.append(src, [3, 31]), np.append(dst, [3, 31])
    glab = rng.randint(0, 7, 4).astype(np.int32)

    def jloss(p):
        return jgnn.loss_graph_batch(p, jnp.asarray(feats), src, dst, gid,
                                     glab, 4, jcfg)

    want, jgr = jax.value_and_grad(jloss)(jp)
    loss = gnn.loss_graph_batch(model, _t(feats), _t(src), _t(dst), _t(gid),
                                _t(glab), 4, tcfg)
    _close(loss, want)
    _grads_close(model, loss, jgr)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_csr_embeddings_match_the_edge_list(params, aggregator, monkeypatch):
    """``node_embeddings_csr`` in blocks of a few rows equals the whole
    edge list's embeddings, and the JAX example's layer loop."""
    jcfg, tcfg = _cfgs(aggregator)
    jp, model = params
    g = graph.synthetic_graph(3, 200, 5, 32, num_classes=7)
    src, dst = g.edge_list()
    monkeypatch.setattr(gnn, "CSR_BLOCK_ELEMS", 40 * 32)
    assert len(gnn.csr_blocks(g.indptr, 40)) > 10
    got = gnn.node_embeddings_csr(model, _t(g.feats), g.indptr,
                                  _t(g.indices), tcfg)
    full = gnn.node_embeddings_full(model, _t(g.feats), _t(src), _t(dst),
                                    tcfg)
    assert torch.equal(got, full.detach())
    h = jnp.asarray(g.feats)
    for l in range(jcfg.num_layers):
        h = jgnn._sage_layer(jp[f"layer{l}"], h, jgnn._aggregate_edges(
            h, jnp.asarray(src), jnp.asarray(dst), g.num_nodes, aggregator))
    _close(got, h)


def _blocked_case(seed: int, N: int = 90, E: int = 700, d: int = 24):
    """Features and an edge list with ties under max (each node's first
    in-edge repeated) and a node without an in-edge (5)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(N, d).astype(np.float32)
    src = rng.randint(0, N, E)
    dst = rng.randint(0, N, E)
    dst[dst == 5] = 6
    src = np.concatenate([src, src[:40]])
    dst = np.concatenate([dst, dst[:40]])
    return h, _t(src), _t(dst)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_blocked_aggregation_is_the_reference(aggregator, monkeypatch):
    """``aggregate`` in many blocks (CSR_BLOCK_ELEMS cut to a few rows, the
    transposed plan too): the forward bit-equal to
    ``aggregate_edges_ref``, the gradient of h within 1e-5 of the
    reference's largest entry, for a cotangent with every entry set and
    one that leaves the empty segment out (under max its row is −inf)."""
    h_np, src, dst = _blocked_case(11)
    N, d = h_np.shape
    monkeypatch.setattr(gnn, "CSR_BLOCK_ELEMS", 60 * d)
    plan = gnn.EdgePlan.from_edges(src, dst, N)
    assert len(plan.blocks(d)) > 8
    assert len(plan.transposed().blocks(d)) > 8
    cot = torch.from_numpy(np.random.RandomState(4).randn(N, d).astype(
        np.float32))
    cot[5] = 0.0
    h1 = torch.from_numpy(h_np).requires_grad_(True)
    h2 = torch.from_numpy(h_np).requires_grad_(True)
    got = gnn.aggregate(h1, plan, aggregator)
    want = gnn.aggregate_edges_ref(h2, src, dst, N, aggregator)
    assert torch.equal(got, want)
    keep = torch.isfinite(want)
    (g1,) = torch.autograd.grad(got, h1, torch.where(keep, cot, 0.0))
    (g2,) = torch.autograd.grad(want, h2, torch.where(keep, cot, 0.0))
    _close(g1, g2.numpy())
    assert float(g2.abs().max()) > 0


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_blocked_losses_match_jax(params, aggregator, monkeypatch):
    """The full-graph loss (full_graph_sm-like: 120 nodes, 900 edges) and
    the graph-batch loss (6 graphs of 20 nodes) in many blocks against the
    JAX package: losses and every leaf's gradient within 1e-5 of the
    largest entry; and the blocked full-graph gradients against the
    reference path's, the same model, to the same 1e-5."""
    jcfg, tcfg = _cfgs(aggregator)
    jp, model = params
    monkeypatch.setattr(gnn, "CSR_BLOCK_ELEMS", 50 * JCFG.d_in)
    N = 120
    feats, src, dst = _random_edges(N, 900, 8)
    src, dst = np.append(src, np.arange(N)), np.append(dst, np.arange(N))
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    labels = np.random.RandomState(9).randint(0, 7, N).astype(np.int32)
    mask = np.random.RandomState(10).rand(N) < 0.5
    plan = gnn.EdgePlan.from_edges(_t(src), _t(dst), N)
    assert len(plan.blocks(JCFG.d_hidden)) > 8

    def jloss(p):
        return jgnn.loss_full_batch(p, jnp.asarray(feats), src, dst,
                                    labels, mask, jcfg)

    jl, jg = jax.value_and_grad(jloss)(jp)
    loss = gnn.loss_full_batch(model, _t(feats), _t(src), _t(dst),
                               _t(labels), _t(mask), tcfg)
    _close(loss, jl)
    named = list(opt_lib.named_leaves(model).values())
    blocked = torch.autograd.grad(loss, named, retain_graph=True)
    _grads_close(model, loss, jg)
    monkeypatch.setattr(gnn, "aggregate", lambda h, pl, agg:
                        gnn.aggregate_edges_ref(h, _t(src), _t(dst), N, agg))
    ref = gnn.loss_full_batch(model, _t(feats), _t(src), _t(dst),
                              _t(labels), _t(mask), tcfg)
    assert torch.equal(loss, ref)
    for a, b in zip(blocked, torch.autograd.grad(ref, named)):
        _close(a, b.numpy())
    monkeypatch.undo()
    monkeypatch.setattr(gnn, "CSR_BLOCK_ELEMS", 30 * JCFG.d_in)
    rng = np.random.RandomState(12)
    G, n = 6, 20
    gfeats = rng.randn(G * n, JCFG.d_in).astype(np.float32)
    local = rng.randint(0, n, (2, G, 50))
    gsrc = np.concatenate([(local[0] + n * np.arange(G)[:, None]).ravel(),
                           np.arange(G * n)]).astype(np.int32)
    gdst = np.concatenate([(local[1] + n * np.arange(G)[:, None]).ravel(),
                           np.arange(G * n)]).astype(np.int32)
    gid = np.repeat(np.arange(G), n).astype(np.int32)
    glab = rng.randint(0, 7, G).astype(np.int32)
    want, jgr = jax.value_and_grad(lambda p: jgnn.loss_graph_batch(
        p, jnp.asarray(gfeats), gsrc, gdst, gid, glab, G, jcfg))(jp)
    loss = gnn.loss_graph_batch(model, _t(gfeats), _t(gsrc), _t(gdst),
                                _t(gid), _t(glab), G, tcfg)
    _close(loss, want)
    _grads_close(model, loss, jgr)


def test_ogb_products_cell_is_reckoned_blocked_and_runs_whole():
    """graphsage-reddit × ogb_products: the reckoning holds one block of
    messages (2²⁸ elements), not E·(F + h), and fits one card whole; the
    cell runs whole through ``run_cell`` on the CPU (its smoke sizes),
    every step's loss finite, and two runs from one seed give the same
    losses bit for bit."""
    from repro_torch.launch import cells, dryrun
    cell = cells.build_cell("graphsage-reddit", "ogb_products")
    meta = cell.meta
    rk = dryrun.reckon(cell, meta["cfg"], meta["batch"], meta["accum"])
    assert rk["terms"]["messages"] == 2 * gnn.CSR_BLOCK_ELEMS * 4
    assert rk["peak_bytes"] < 0.5 * dryrun.PLAN_SHARE * 80e9
    assert dryrun.plans(cell, dryrun.PLAN_SHARE * 80e9)[0].why == "whole"
    small = cells.build_cell("graphsage-reddit", "ogb_products", smoke=True)
    plan = dryrun.Plan((None,), (small.meta["batch"],), 1, 3, "whole")
    runs = [dryrun.run_cell("graphsage-reddit", "ogb_products",
                            device="cpu", verbose=False, plan=plan)
            for _ in range(2)]
    for rec in runs:
        assert rec["ok"], rec.get("traceback")
        assert rec["fits_hbm"]
        (point,) = rec["measured_at"]
        assert len(point["losses"]) == 4
        assert all(np.isfinite(point["losses"]))
    assert runs[0]["measured_at"][0]["losses"] == \
        runs[1]["measured_at"][0]["losses"]


def test_gnn_index_bench_at_the_example_sizes():
    """bench/gnn_index.py at examples/gnn_index.py's sizes on the CPU:
    the minibatch training falls, both solvers' distortion and recall are
    finite, every R orthogonal, the frozen R the identity, and each index
    finds the probes' communities far above chance."""
    out = gnn_index.run(device="cpu")
    losses = out["losses"]
    assert np.all(np.isfinite(losses)) and np.mean(losses[-10:]) < np.mean(
        losses[:10])
    assert out["embeddings"] == [2000, 64]
    for solver, r in out["solvers"].items():
        assert np.isfinite(r["distortion"]) and 0.0 <= r["recall"] <= 1.0
        assert r["orthogonality_error"] < 1e-5, solver
    assert out["solvers"]["frozen"]["r_moved"] == 0.0
    assert out["solvers"]["gcd_greedy"]["r_moved"] > 0.0
    assert out["exact_community_share"] >= gnn_index.COMMUNITY_MIN
    assert out["chance_share"] < 0.2
    for r in out["solvers"].values():
        assert r["community_share"] >= gnn_index.COMMUNITY_MIN
    assert all(out["checks"].values()), out["checks"]


def test_gnn_index_scores_a_random_index_at_chance():
    """The community share falls to chance when the index's ids are
    random, and recall_excluding_self and community_share never count the
    probe itself."""
    labels = np.random.RandomState(0).randint(0, 8, size=4000)
    chance = gnn_index.chance_share(labels)
    assert abs(chance - 1 / 8) < 0.01
    ids = np.random.RandomState(1).randint(0, 4000, size=(500, 11))
    assert abs(gnn_index.community_share(ids, labels, 500) - chance) < 0.03
    assert gnn_index.community_share(ids, labels, 500) < gnn_index.COMMUNITY_MIN
    same = np.stack([np.r_[i, np.flatnonzero(labels == labels[i])[:10]]
                     for i in range(500)])
    assert gnn_index.community_share(same, labels, 500) == 1.0
    selfish = np.stack([np.r_[i, -1, (i + 1 + np.arange(10)) % 4000]
                        for i in range(50)])
    truth = (np.arange(50)[:, None] + 1 + np.arange(10)) % 4000
    assert gnn_index.recall_excluding_self(selfish, truth, 50) == 1.0
