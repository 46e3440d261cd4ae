"""GraphSAGE → trainable PQ index: the paper's technique on GNN embeddings
(port of ``examples/gnn_index.py``).

GraphSAGE's unsupervised use produces node embeddings that feed
nearest-neighbour retrieval, which is where the paper's index layer slots
in. This script trains GraphSAGE on minibatch blocks of a synthetic
community graph, takes the full-graph node embeddings, fits OPQ on them
with the rotation frozen and learned by GCD-G (``quant.opq.fit``), serves
each fitted quantizer through ``flat_adc`` (its own codebooks, no refit),
and scores neighbour recall@10 against the ``exact`` backend, a node never
counting itself. On the card the index side runs the ``pq_assign``,
``gcd_score``, ``givens_rotate`` and ``adc_lookup`` kernels.

The example's sizes are the defaults (2,000 nodes of average degree 8, 32
features, 8 classes; d_hidden 64, fanout (8, 4); 120 steps of 64 seeds at
lr 3e-3; PQConfig(8, 32); OPQ 15 iterations of 5 inner steps at lr 2e-3;
200 probes). The parameters come from a generator seeded with ``seed``,
the learner's from ``seed + 1`` and OPQ's from ``seed + 3``, as the
example's keys 0, 1 and 3; batch i draws from ``RandomState(i)``.

Checks (exit 1 when one fails): every loss finite, each solver's
distortion and recall finite, each R orthogonal to 1e-5, and at least
``COMMUNITY_MIN`` of each probe's top 10 in the probe's own community
(``community_share``; ``chance_share`` is what random ids score). The
example prints the distortion and recall and holds nothing more.

Usage:
  PYTHONPATH=src python3 -m repro_torch.bench.gnn_index [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import rotations, search
from repro_torch.bench import common
from repro_torch.data import graph as graph_lib
from repro_torch.models import gnn
from repro_torch.quant import opq
from repro_torch.quant.base import PQConfig
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

SOLVERS = ("frozen", "gcd_greedy")
ORTH_TOL = 1e-5
# The least share of a probe's top 10 in its own community. Within a
# community the embeddings are near-equal, so recall@10 sits near chance
# whether the index works or not; the community is what a working index
# finds (0.9998-1.0 on the CPU at the example's sizes and at d_in 602 with
# 41 classes) and a random one does not (chance_share: 0.125 and 0.024).
COMMUNITY_MIN = 0.9


def top10_excluding_self(pred_ids: np.ndarray, i: int) -> list[int]:
    """Row i's first 10 valid ids other than i (the probes are corpus rows,
    which a searcher returns at rank ~0)."""
    return [p for p in pred_ids[i].tolist() if p != i and p >= 0][:10]


def recall_excluding_self(pred_ids: np.ndarray, true_ids: np.ndarray,
                          rows: int) -> float:
    """Neighbour recall@10 where a node never counts itself as a hit."""
    return float(np.mean([
        len(set(top10_excluding_self(pred_ids, i))
            & set(true_ids[i].tolist())) / 10 for i in range(rows)]))


def community_share(pred_ids: np.ndarray, labels: np.ndarray,
                    rows: int) -> float:
    """The share of each probe's top 10 (itself left out) that lies in the
    probe's own community, over the first ``rows`` probes."""
    return float(np.mean([
        np.mean(labels[top10_excluding_self(pred_ids, i)] == labels[i])
        for i in range(rows)]))


def chance_share(labels: np.ndarray) -> float:
    """The community share an index of random ids scores: the chance that
    two nodes drawn at random share a community, sum_c (n_c / N)^2."""
    frac = np.bincount(labels) / len(labels)
    return float(np.sum(frac * frac))


def train_step_fn(cfg: gnn.GraphSAGEConfig, ocfg: opt_lib.OptimizerConfig):
    """The minibatch train step: (state, *blocks, labels)."""
    return ts.make_train_step(
        lambda p, *b: gnn.loss_minibatch(p, list(b[:-1]), b[-1], cfg), ocfg)


def train_sage(graph: graph_lib.CSRGraph, feats: torch.Tensor,
               cfg: gnn.GraphSAGEConfig, *, steps: int, batch: int, lr: float,
               warmup: int, seed: int = 0):
    """GraphSAGE trained on ``steps`` minibatches of ``batch`` seeds (batch
    i drawn from ``RandomState(i)``), gathered from ``feats`` (the graph's
    features on the device the model trains on). Returns (model,
    losses)."""
    dev = feats.device
    model = gnn.GraphSAGE.init(_device.generator(seed, dev), cfg, device=dev)
    ocfg = opt_lib.OptimizerConfig(lr=lr, total_steps=steps,
                                   warmup_steps=warmup)
    state = ts.init_state(_device.generator(seed + 1, dev), model, ocfg)
    step = train_step_fn(cfg, ocfg)
    losses = []
    for i in range(steps):
        seeds = np.random.RandomState(i).randint(0, graph.num_nodes,
                                                 size=batch)
        blocks, labels = graph_lib.sample_blocks(
            graph, seeds, cfg.sample_sizes, i, feats)
        state, m = step(state, *blocks, labels)
        losses.append(float(m["loss"]))
    return state.params, losses


def embeddings(model, graph: graph_lib.CSRGraph, feats: torch.Tensor,
               cfg: gnn.GraphSAGEConfig):
    """The full-graph node embeddings (N, d_hidden) on ``feats``' device,
    the classifier's input (``gnn.node_embeddings_csr``)."""
    indices = torch.from_numpy(graph.indices).to(feats.device)
    return gnn.node_embeddings_csr(model, feats, graph.indptr, indices, cfg)


def neighbour_truth(h: torch.Tensor, probes: int) -> np.ndarray:
    """The exact 10 nearest rows (inner product, through the ``exact``
    backend) of each of the first ``probes`` rows of ``h``, itself left
    out."""
    exact = search.make("exact")
    state = exact.build(None, h, torch.eye(h.shape[1], dtype=h.dtype,
                                           device=h.device),
                        search.SearchConfig(), device=h.device)
    ids = exact.search(state, h[:probes], k=11).ids.cpu().numpy()
    return np.stack([np.asarray([p for p in ids[i].tolist() if p != i][:10])
                     for i in range(probes)])


def index_recall(h: torch.Tensor, truth: np.ndarray, labels: np.ndarray,
                 pq_cfg: PQConfig, *, iters: int, inner_steps: int, lr: float,
                 seed: int = 3) -> dict:
    """For each of ``SOLVERS``: OPQ fitted on ``h`` (a generator seeded ``seed``
    each), its quantizer served through ``flat_adc`` and searched with the
    ``len(truth)`` probes. Returns {solver: distortion, recall,
    community_share (``labels`` the nodes' communities),
    orthogonality_error, r_moved (‖R − I‖_F)}."""
    probes = truth.shape[0]
    flat = search.make("flat_adc")
    out = {}
    for solver in SOLVERS:
        g = _device.generator(seed, h.device)
        R, pqz, trace = opq.fit(g, h, pq_cfg, iters=iters, rotation=solver,
                                inner_steps=inner_steps, lr=lr)
        state = flat.from_quantizer(R, pqz, h)
        ids = flat.search(state, h[:probes], k=11).ids.cpu().numpy()
        eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
        out[solver] = dict(
            distortion=float(trace[-1]),
            recall=recall_excluding_self(ids, truth, probes),
            community_share=community_share(ids, labels, probes),
            orthogonality_error=float(rotations.orthogonality_error(R)),
            r_moved=float(torch.linalg.matrix_norm(R - eye)))
    return out


def checks_of(losses, solvers: dict) -> dict:
    return dict(
        losses_finite=all(math.isfinite(v) for v in losses),
        index_finite=all(math.isfinite(r["distortion"])
                         and math.isfinite(r["recall"])
                         for r in solvers.values()),
        r_orthogonal=all(r["orthogonality_error"] <= ORTH_TOL
                         for r in solvers.values()),
        index_finds_communities=all(
            r["community_share"] >= COMMUNITY_MIN for r in solvers.values()))


def run(*, nodes: int = 2000, avg_degree: int = 8, d_feat: int = 32,
        classes: int = 8, d_hidden: int = 64, fanout=(8, 4),
        steps: int = 120, batch: int = 64, lr: float = 3e-3,
        warmup: int = 10, probes: int = 200, subspaces: int = 8,
        codewords: int = 32, opq_iters: int = 15, inner_steps: int = 5,
        opq_lr: float = 2e-3, seed: int = 0, device=None) -> dict:
    """The example end to end at these sizes; a dict of the losses, the
    embeddings' shape, each solver's numbers and the checks."""
    dev = _device.resolve(device)
    graph = graph_lib.synthetic_graph(seed, nodes, avg_degree, d_feat,
                                      num_classes=classes)
    cfg = gnn.GraphSAGEConfig(name="sage", d_in=d_feat, d_hidden=d_hidden,
                              num_classes=classes, sample_sizes=tuple(fanout))
    feats = torch.from_numpy(graph.feats).to(dev)
    model, losses = train_sage(graph, feats, cfg, steps=steps, batch=batch,
                               lr=lr, warmup=warmup, seed=seed)
    h = embeddings(model, graph, feats, cfg)
    truth = neighbour_truth(h, probes)
    solvers = index_recall(h, truth, graph.labels,
                           PQConfig(subspaces, codewords), iters=opq_iters,
                           inner_steps=inner_steps, lr=opq_lr, seed=seed + 3)
    return dict(losses=losses, embeddings=list(h.shape), solvers=solvers,
                exact_community_share=community_share(
                    truth, graph.labels, probes),
                chance_share=chance_share(graph.labels),
                checks=checks_of(losses, solvers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the "
                         "card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = run(seed=args.seed, device=args.device)
    dev = _device.resolve(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    losses = out["losses"]
    common.emit("gnn_index", "train", device=kind, steps=len(losses),
                loss_first=losses[0], loss_last=losses[-1])
    common.emit("gnn_index", "communities",
                exact_share=out["exact_community_share"],
                chance_share=out["chance_share"])
    for solver, r in out["solvers"].items():
        common.emit("gnn_index", solver, **r)
    common.emit("gnn_index", "checks", **out["checks"])
    return 0 if all(out["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
