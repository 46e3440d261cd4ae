"""Graph substrate (port of ``repro/data/graph.py``): CSR storage,
synthetic power-law graphs, and the neighbour sampler of GraphSAGE's
minibatch training (fanout 15-10 in the minibatch_lg cell).

The sampler is uniform with replacement over each node's CSR row, exactly
GraphSAGE's; an isolated node samples itself. ``synthetic_graph`` and
``sample_neighbors_np`` draw from numpy's ``RandomState`` in the JAX
package's order, so a seed gives both packages the same graph and the same
blocks, bit for bit. Where the JAX generator picks each same-community
neighbour with one ``randint`` call in a Python loop, this one makes one
call over an array of bounds, which draws the same stream (minutes at
Reddit's 114.6M edges become seconds). ``sample_blocks`` gathers its blocks
from the features on the caller's device; ``sample_neighbors`` is the
device sampler over a
padded adjacency, on a ``torch.Generator`` (the JAX package's
``sample_neighbors_jax`` draws from a JAX key instead).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device


class CSRGraph(NamedTuple):
    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,) int32: the neighbours of each row, in order
    feats: np.ndarray    # (N, F) float32
    labels: np.ndarray   # (N,) int32

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def edge_list(self):
        """(src, dst) arrays: src the neighbour, dst the row node, in CSR
        order (so dst is sorted)."""
        dst = np.repeat(np.arange(self.num_nodes), np.diff(self.indptr))
        return self.indices.copy(), dst


def synthetic_graph(seed: int, num_nodes: int, avg_degree: int, d_feat: int,
                    num_classes: int = 41) -> CSRGraph:
    """Power-law-ish random graph with community-correlated features and
    labels: the JAX package's graph of the same arguments."""
    rng = np.random.RandomState(seed)
    # preferential-attachment-flavoured degree sequence
    deg = np.minimum(
        rng.zipf(1.6, size=num_nodes), max(4 * avg_degree, 16)
    ).astype(np.int64)
    deg = np.maximum((deg * avg_degree / max(deg.mean(), 1)).astype(np.int64), 1)
    total = int(deg.sum())
    comm = rng.randint(0, num_classes, size=num_nodes)
    # endpoints biased toward the same community
    dst = np.repeat(np.arange(num_nodes), deg)
    same = rng.rand(total) < 0.6
    rand_nbr = rng.randint(0, num_nodes, size=total)
    # a same-community neighbour: a uniform member of dst's community, the
    # members of each community in ascending order (np.where's order)
    members = np.argsort(comm, kind="stable")
    sizes = np.bincount(comm, minlength=num_classes)
    first = np.cumsum(sizes) - sizes
    src = rand_nbr
    if same.any():
        c = comm[dst[same]]
        src[same] = members[first[c] + rng.randint(0, sizes[c])]
    # dst is sorted already: the JAX package's stable argsort is the identity
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    centers = rng.randn(num_classes, d_feat).astype(np.float32)
    feats = centers[comm] + 0.5 * rng.randn(num_nodes, d_feat).astype(np.float32)
    return CSRGraph(indptr=indptr, indices=src.astype(np.int32),
                    feats=feats, labels=comm.astype(np.int32))


def sample_neighbors_np(graph: CSRGraph, nodes: np.ndarray, fanout: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Uniform-with-replacement CSR sampling: (B,) -> (B, fanout) int32;
    an isolated node gets itself ``fanout`` times."""
    starts = graph.indptr[nodes]
    degs = graph.indptr[nodes + 1] - starts
    r = rng.randint(0, 1 << 30, size=(len(nodes), fanout))
    out = np.repeat(nodes.astype(np.int32)[:, None], fanout, axis=1)
    live = degs > 0
    offs = r[live] % degs[live, None]
    out[live] = graph.indices[starts[live, None] + offs]
    return out


def sample_ids(graph: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
               seed: int) -> list[np.ndarray]:
    """The node ids of each hop of a GraphSAGE minibatch: [(B,), (B, f1),
    (B, f1, f2), ...] int64, drawn from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    frontier = [seeds.astype(np.int64)]
    for f in fanouts:
        flat = frontier[-1].reshape(-1)
        nbrs = sample_neighbors_np(graph, flat, f, rng)
        frontier.append(nbrs.reshape(*frontier[-1].shape, f).astype(np.int64))
    return frontier


def sample_blocks(graph: CSRGraph, seeds: np.ndarray,
                  fanouts: tuple[int, ...], seed: int, feats: torch.Tensor):
    """GraphSAGE minibatch blocks: the features at each hop, dense layout,
    [(B, F), (B, f1, F), (B, f1, f2, F), ...] ready for
    ``models.gnn.minibatch_forward``, and the seeds' labels (B,) int64.

    ``feats``: the graph's features, (N, F), uploaded once by the caller to
    the device the blocks are wanted on; the ids are drawn on the host and
    the blocks gathered there. They equal the JAX package's blocks."""
    dev = feats.device
    ids = sample_ids(graph, seeds, fanouts, seed)
    blocks = [feats[torch.from_numpy(i).to(dev)] for i in ids]
    labels = torch.from_numpy(graph.labels[seeds].astype(np.int64)).to(dev)
    return blocks, labels


def padded_adjacency(graph: CSRGraph, max_degree: int, *, device=None):
    """Dense (N, max_degree) int64 neighbour matrix (−1 padded; a row keeps
    its first ``max_degree`` neighbours) and (N,) int64 degrees capped at
    ``max_degree``, on ``device`` (the card by default): the device-resident
    form the device sampler reads."""
    dev = _device.resolve(device)
    deg = np.minimum(np.diff(graph.indptr), max_degree)
    cols = np.arange(max_degree)
    keep = cols[None, :] < deg[:, None]
    adj = -np.ones((graph.num_nodes, max_degree), np.int64)
    adj[keep] = graph.indices[(graph.indptr[:-1, None] + cols)[keep]]
    return (torch.from_numpy(adj).to(dev),
            torch.from_numpy(deg.astype(np.int64)).to(dev))


def sample_neighbors(generator: torch.Generator, adj: torch.Tensor,
                     deg: torch.Tensor, nodes: torch.Tensor,
                     fanout: int) -> torch.Tensor:
    """Uniform sampler over the padded adjacency on the adjacency's device:
    nodes (...) -> (..., fanout) int64; an isolated node gets itself."""
    _device.check_generator(generator, adj.device)
    nodes = nodes.long()
    r = torch.randint(0, 1 << 30, (*nodes.shape, fanout),
                      generator=generator, device=adj.device)
    cols = r % torch.clamp(deg[nodes], min=1)[..., None]
    nbrs = adj[nodes[..., None], cols]
    return torch.where(nbrs >= 0, nbrs, nodes[..., None])
