"""GraphSAGE (Hamilton et al. 2017), port of ``repro/models/gnn.py``.

Message passing gathers h[src] and reduces it into dst's segment. The JAX
package uses ``jax.ops.segment_sum``/``segment_max``, which are plain XLA
there; here the edges are stably sorted by dst and ``torch.segment_reduce``
sums (or takes the max of) each segment's rows in edge order, so a seed
gives one answer on the card too (``index_add_`` adds in no fixed order
there), as ``quant.kmeans.segment_sum`` does. A node with no in-edge gets 0
under ``mean`` and −inf under ``max``, as in JAX; the degree counts are sums
of 1.0, exact in any order.

Every full-graph mode aggregates through one blocked path
(``aggregate``): an ``EdgePlan`` holds the edges sorted by dst, and the
messages are gathered and reduced a block of dst rows at a time
(``csr_blocks``, at most ``CSR_BLOCK_ELEMS`` message elements a block), so
no (E, d) message tensor outlives a block, in the forward or the backward
(ogb_products: 61.9M edges, 24.7 GB of layer-0 messages in float32). The
backward of ``mean`` sums, for each node, grad[dst] / deg[dst] over its
out-edges: a ``segment_reduce`` over the plan's transposed order (the
dst-sorted edges stably sorted by src), blocked the same way, so each
node's terms are added in the order of the dst-sorted list and no
``index_add_`` runs. The backward of ``max`` recomputes each block's
messages and shares a tie's gradient evenly among the tied rows, as
``jax.ops.segment_max`` does (the tie counts are an (N, d) tensor), then
sums it over the transposed order. ``aggregate_edges_ref``, the gather of
all E messages then one reduce, is the plain reference the tests and the
smoke hold the blocked path to; no mode calls it.

Three execution modes:
  * ``full_batch_forward`` — whole-graph propagation from an edge list
    (full_graph_sm, ogb_products); ``loss_graph_batch`` the same on a
    disjoint union of small graphs, mean-pooled per graph (molecule);
  * ``minibatch_forward`` — seed nodes and dense fanout blocks from
    ``data.graph.sample_blocks`` (minibatch_lg), GraphSAGE's own training
    mode;
  * ``node_embeddings_csr`` — the full-graph embeddings of a CSR graph
    without gradients (a graph of 114.6M edges), its CSR rows the plan.

``GraphSAGE`` is a ``models.param.Params`` module whose parameter names are
the JAX leaf names: ``layer{l}.w_self``, ``layer{l}.w_neigh``,
``layer{l}.b`` and ``classifier``. The paper's index layer attaches to the
output node embeddings (``bench/gnn_index.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import param
from repro_torch.models.param import ParamSpec
from repro_torch.sharding import rules as sh

#: elements of a message block the aggregation gathers at a time
CSR_BLOCK_ELEMS = 1 << 28


class GraphSAGEConfig(NamedTuple):
    name: str
    d_in: int
    d_hidden: int = 128
    num_layers: int = 2
    num_classes: int = 41
    aggregator: str = "mean"          # mean | max
    sample_sizes: tuple[int, ...] = (25, 10)
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    rules: str = "gnn"

    @property
    def rule_table(self) -> dict:
        return sh.RULE_REGISTRY[self.rules]


def param_specs(cfg: GraphSAGEConfig) -> dict:
    specs = {}
    d_prev = cfg.d_in
    for l in range(cfg.num_layers):
        specs[f"layer{l}"] = {
            "w_self": ParamSpec((d_prev, cfg.d_hidden), ("w_in", "w_out")),
            "w_neigh": ParamSpec((d_prev, cfg.d_hidden), ("w_in", "w_out")),
            "b": ParamSpec((cfg.d_hidden,), ("w_out",), init="zeros"),
        }
        d_prev = cfg.d_hidden
    specs["classifier"] = ParamSpec((cfg.d_hidden, cfg.num_classes),
                                    ("w_in", None))
    return specs


class GraphSAGE(param.Params):
    """The model's parameters; the functions below take it as ``params``."""

    @classmethod
    def init(cls, generator: torch.Generator, cfg: GraphSAGEConfig, *,
             device=None) -> "GraphSAGE":
        """Fresh parameters on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return cls(param.init_params(generator, param_specs(cfg),
                                     cfg.param_dtype, device=dev))


class _SegmentMax(torch.autograd.Function):
    """``segment_reduce``'s max with ``jax.ops.segment_max``'s gradient:
    shared evenly among the rows that tie at their segment's max (a node
    sampled twice as one node's neighbour). ``segment_reduce``'s own
    backward gives each tied row the whole gradient on the CPU."""

    @staticmethod
    def forward(ctx, msgs: torch.Tensor, lengths: torch.Tensor):
        out = torch.segment_reduce(msgs, "max", lengths=lengths, unsafe=True)
        ctx.save_for_backward(msgs, lengths, out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        msgs, lengths, out = ctx.saved_tensors
        seg = _segment_ids(lengths)
        hit = (msgs == out[seg]).to(grad.dtype)
        ties = torch.segment_reduce(hit, "sum", lengths=lengths, unsafe=True)
        return hit * (grad / torch.clamp(ties, min=1.0))[seg], None


def _segment_ids(lengths: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Each row's segment, first + 0 … for rows sorted by segment."""
    return torch.repeat_interleave(
        torch.arange(first, first + lengths.shape[0],
                     device=lengths.device), lengths)


def _segment(msgs: torch.Tensor, lengths: torch.Tensor,
             aggregator: str) -> torch.Tensor:
    """Each segment's rows of ``msgs`` (sorted by segment, ``lengths``
    rows a segment) reduced in row order: the sum, the sum / count
    (``mean``) or the max."""
    if aggregator == "max":
        return torch.segment_reduce(msgs, "max", lengths=lengths,
                                    unsafe=True)
    s = torch.segment_reduce(msgs, "sum", lengths=lengths, unsafe=True)
    if aggregator == "sum":
        return s
    if aggregator == "mean":
        return s / torch.clamp(lengths.to(s.dtype), min=1.0)[:, None]
    raise ValueError(aggregator)


def aggregate_edges_ref(h: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, num_nodes: int,
                        aggregator: str) -> torch.Tensor:
    """The plain reference: all E messages h[src] gathered in dst order,
    then reduced into dst's segment: h (N, d) -> (N, d); the gradient by
    autograd (``_SegmentMax`` for ``max``)."""
    dst = dst.long()
    order = torch.sort(dst, stable=True)[1]
    lengths = torch.bincount(dst, minlength=num_nodes)
    msgs = h[src.long()[order]]
    if aggregator == "max":
        return _SegmentMax.apply(msgs, lengths)
    return _segment(msgs, lengths, aggregator)


class EdgePlan:
    """A graph's edges as the blocked aggregation reads them: ``src`` the
    edges' sources sorted stably by destination, ``lengths`` each node's
    in-degree and ``indptr`` its host prefix sum (the row ranges
    ``csr_blocks`` cuts); ``transposed()``, built on a backward's first
    call and kept, is the same edge list stably sorted by source, as a
    plan of its own whose ``src`` holds each edge's destination."""

    def __init__(self, src: torch.Tensor, lengths: torch.Tensor,
                 indptr: np.ndarray):
        self.src = src
        self.lengths = lengths
        self.indptr = indptr
        self._transposed = None

    @classmethod
    def from_edges(cls, src: torch.Tensor, dst: torch.Tensor,
                   num_nodes: int) -> "EdgePlan":
        dst = dst.long()
        order = torch.sort(dst, stable=True)[1]
        return cls.from_lengths(src[order],
                                torch.bincount(dst, minlength=num_nodes))

    @classmethod
    def from_lengths(cls, src: torch.Tensor,
                     lengths: torch.Tensor) -> "EdgePlan":
        indptr = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
        np.cumsum(lengths.cpu().numpy(), out=indptr[1:])
        return cls(src, lengths, indptr)

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: torch.Tensor
                 ) -> "EdgePlan":
        """A CSR graph's plan: row r's neighbours ``indices[indptr[r]:
        indptr[r + 1]]`` are the sources of r's in-edges."""
        indptr = np.asarray(indptr, dtype=np.int64)
        return cls(indices, torch.from_numpy(np.diff(indptr)).to(
            indices.device), indptr)

    @property
    def num_nodes(self) -> int:
        return self.lengths.shape[0]

    def blocks(self, width: int) -> list[tuple[int, int, int, int]]:
        """(r0, r1, e0, e1): row and edge ranges of blocks of at most
        CSR_BLOCK_ELEMS message elements of ``width``."""
        return [(r0, r1, int(self.indptr[r0]), int(self.indptr[r1]))
                for r0, r1 in csr_blocks(self.indptr,
                                         max(1, CSR_BLOCK_ELEMS // width))]

    def transposed(self) -> "EdgePlan":
        if self._transposed is None:
            by_src = torch.sort(self.src, stable=True)[1]
            self._transposed = EdgePlan.from_lengths(
                _segment_ids(self.lengths)[by_src],
                torch.bincount(self.src.long(), minlength=self.num_nodes))
        return self._transposed


def _blocked(h: torch.Tensor, plan: EdgePlan,
             aggregator: str) -> torch.Tensor:
    out = h.new_empty((plan.num_nodes, h.shape[1]))
    for r0, r1, e0, e1 in plan.blocks(h.shape[1]):
        out[r0:r1] = _segment(h[plan.src[e0:e1].long()],
                              plan.lengths[r0:r1], aggregator)
    return out


class _BlockedAggregate(torch.autograd.Function):
    """The blocked aggregation with its blocked backward (module
    docstring); saves h and the output for ``max``, nothing of E size."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, plan: EdgePlan, aggregator: str):
        out = _blocked(h, plan, aggregator)
        ctx.plan, ctx.aggregator = plan, aggregator
        if aggregator == "max":
            ctx.save_for_backward(h, out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        plan = ctx.plan
        t = plan.transposed()
        if ctx.aggregator == "mean":
            deg = torch.clamp(plan.lengths.to(grad.dtype), min=1.0)
            return _blocked(grad / deg[:, None], t, "sum"), None, None
        h, out = ctx.saved_tensors
        ties = torch.empty_like(out)
        for r0, r1, e0, e1 in plan.blocks(h.shape[1]):
            lengths = plan.lengths[r0:r1]
            hit = h[plan.src[e0:e1].long()] == out[_segment_ids(lengths, r0)]
            ties[r0:r1] = torch.segment_reduce(hit.to(grad.dtype), "sum",
                                               lengths=lengths, unsafe=True)
        share = grad / torch.clamp(ties, min=1.0)
        dh = torch.empty_like(h)
        for u0, u1, j0, j1 in t.blocks(h.shape[1]):
            lengths = t.lengths[u0:u1]
            dst = t.src[j0:j1]
            hit = h[_segment_ids(lengths, u0)] == out[dst]
            dh[u0:u1] = torch.segment_reduce(hit.to(grad.dtype) * share[dst],
                                             "sum", lengths=lengths,
                                             unsafe=True)
        return dh, None, None


def aggregate(h: torch.Tensor, plan: EdgePlan,
              aggregator: str) -> torch.Tensor:
    """Messages h[src] reduced into dst's segment over ``plan``, in blocks:
    h (N, d) -> (N, d) (``mean`` or ``max``), bit-equal in the forward to
    ``aggregate_edges_ref``."""
    if aggregator not in ("mean", "max"):
        raise ValueError(aggregator)
    return _BlockedAggregate.apply(h, plan, aggregator)


def _aggregate_edges(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     num_nodes: int, aggregator: str) -> torch.Tensor:
    """``aggregate`` over an edge list's plan: h (N, d) -> (N, d)."""
    return aggregate(h, EdgePlan.from_edges(src, dst, num_nodes), aggregator)


def _sage_layer(lp, h_self: torch.Tensor, h_neigh: torch.Tensor
                ) -> torch.Tensor:
    out = h_self @ lp.w_self.to(h_self.dtype)
    out = out + h_neigh @ lp.w_neigh.to(h_neigh.dtype)
    out = torch.relu(out + lp.b.to(out.dtype))
    # L2-normalise as in the paper (Algorithm 1, line 7)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


def _layer(params, l: int):
    return getattr(params, f"layer{l}")


def node_embeddings_full(params, feats: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, cfg: GraphSAGEConfig
                         ) -> torch.Tensor:
    """feats (N, F), edge endpoints (E,) each -> embeddings (N, d_hidden)."""
    return _embeddings(params, feats, EdgePlan.from_edges(
        src, dst, feats.shape[0]), cfg)


def _embeddings(params, feats: torch.Tensor, plan: EdgePlan,
                cfg: GraphSAGEConfig) -> torch.Tensor:
    h = feats.to(cfg.dtype)
    for l in range(cfg.num_layers):
        h = _sage_layer(_layer(params, l), h,
                        aggregate(h, plan, cfg.aggregator))
    return h


def full_batch_forward(params, feats: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, cfg: GraphSAGEConfig
                       ) -> torch.Tensor:
    """feats (N, F), edge endpoints (E,) each -> logits (N, C)."""
    h = node_embeddings_full(params, feats, src, dst, cfg)
    return h @ params.classifier.to(h.dtype)


def csr_blocks(indptr: np.ndarray, max_edges: int) -> list[tuple[int, int]]:
    """Consecutive row ranges [r0, r1) of a CSR graph, each holding at most
    ``max_edges`` edges (a row with more holds a range of its own)."""
    N = indptr.shape[0] - 1
    out, r0 = [], 0
    while r0 < N:
        r1 = int(np.searchsorted(indptr, indptr[r0] + max_edges,
                                 side="right")) - 1
        r1 = min(max(r1, r0 + 1), N)
        out.append((r0, r1))
        r0 = r1
    return out


@torch.no_grad()
def node_embeddings_csr(params, feats: torch.Tensor, indptr: np.ndarray,
                        indices: torch.Tensor, cfg: GraphSAGEConfig
                        ) -> torch.Tensor:
    """The embeddings of ``node_embeddings_full`` on a CSR graph's edge
    list (``CSRGraph.edge_list``), (N, d_hidden), without gradients,
    through the blocked aggregation with the CSR rows as its plan.
    ``indptr`` is the host array, ``indices`` the neighbours on the
    features' device."""
    return _embeddings(params, feats, EdgePlan.from_csr(indptr, indices), cfg)


def node_embeddings_minibatch(params, feats_by_hop, cfg: GraphSAGEConfig
                              ) -> torch.Tensor:
    """Minibatch forward from dense fanout blocks (GraphSAGE Algorithm 2).

    ``feats_by_hop``: [(B, F), (B, f1, F), (B, f1, f2, F), ...] from
    ``data.graph.sample_blocks``. Returns the seeds' (B, d_hidden)
    embeddings."""
    h = [f.to(cfg.dtype) for f in feats_by_hop]
    for l in range(cfg.num_layers):
        nxt = []
        for hop in range(len(h) - 1):
            if cfg.aggregator == "mean":
                h_neigh = torch.mean(h[hop + 1], dim=-2)
            else:
                h_neigh = torch.amax(h[hop + 1], dim=-2)
            nxt.append(_sage_layer(_layer(params, l), h[hop], h_neigh))
        h = nxt
    return h[0]


def minibatch_forward(params, feats_by_hop, cfg: GraphSAGEConfig
                      ) -> torch.Tensor:
    return node_embeddings_minibatch(params, feats_by_hop, cfg) @ \
        params.classifier.to(cfg.dtype)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def loss_full_batch(params, feats, src, dst, labels, mask,
                    cfg: GraphSAGEConfig) -> torch.Tensor:
    """Masked node-classification cross-entropy (full-graph training)."""
    nll = _nll(full_batch_forward(params, feats, src, dst, cfg), labels)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_minibatch(params, feats_by_hop, labels,
                   cfg: GraphSAGEConfig) -> torch.Tensor:
    return torch.mean(_nll(minibatch_forward(params, feats_by_hop, cfg),
                           labels))


def loss_graph_batch(params, feats, src, dst, graph_ids, labels,
                     num_graphs: int, cfg: GraphSAGEConfig) -> torch.Tensor:
    """Graph-level classification on a disjoint union of small graphs (the
    molecule cell): propagate on the union, mean-pool each graph's nodes
    (a fixed-order segment sum), classify each graph."""
    h = node_embeddings_full(params, feats, src, dst, cfg)
    gid = graph_ids.long()
    order = torch.sort(gid, stable=True)[1]
    cnt = torch.bincount(gid, minlength=num_graphs)
    pooled = torch.segment_reduce(h[order], "sum", lengths=cnt, unsafe=True)
    pooled = pooled / torch.clamp(cnt.to(h.dtype), min=1.0)[:, None]
    logits = pooled @ params.classifier.to(h.dtype)
    return torch.mean(_nll(logits, labels))
