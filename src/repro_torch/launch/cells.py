"""The grid's cells on one card (port of ``repro/launch/cells.py``).

For every (architecture × shape) cell of ``configs.grid_cells()`` this
module gives, without allocating anything:
  * ``fn(cfg, accum, marks=None)`` — the step: ``training.train_state
    .make_train_step`` with ``_opt_cfg_for``'s optimizer (the GCD update on
    every rotation leaf included), or the serve call (prefill, decode,
    scoring, retrieval; under ``torch.no_grad``) for a config of the
    cell's family at any depth;
  * ``make_inputs(cfg, batch, generator, device, accum)`` — its operands on
    a device at a given depth (the config's ``num_layers``) and batch
    (``meta["batch_unit"]``), drawn from the generator: a fresh train state
    and a batch, or parameters and the call's inputs. Caches and codes are
    filled from the generator; no prefill runs;
  * ``meta`` — ``model_flops`` by the JAX formulas (``cells.py:208-216``,
    ``:263-270``, ``:292-299``, the GNN cells, ``_recsys_flops``), ``kind``,
    and what ``launch.dryrun`` cuts: ``batch`` (a train cell's microbatch:
    the global batch over its accumulation), ``depth`` (LM layers), the
    accumulation and the config.

The JAX module lowers each cell against a mesh with shardings and donated
buffers; on one card there is no sharding, and the train step updates its
parameters in place. ``_opt_cfg_for`` is the JAX file's ``:159-178``.

``build_cell(..., smoke=True)`` gives the same cell at the architecture's
``make_smoke`` config and ``SMOKE_SHAPES``' sizes: what the dry run runs
on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import configs, rotations
from repro_torch.configs import base as cbase
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models import embedding, gnn, param, recsys
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

#: parameters above which an architecture trains with Adafactor in bf16
BIG_PARAMS = 50e9

#: the shapes' sizes at which the CPU runs a cell (the smoke configs'):
#: sequences of 64 (a multiple of the smoke configs' 32-token
#: cross-entropy chunk), a few rows, nodes and candidates
SMOKE_SHAPES = {
    "train_4k": {"seq_len": 64, "global_batch": 16},
    "prefill_32k": {"seq_len": 64, "global_batch": 2},
    "decode_32k": {"seq_len": 64, "global_batch": 2},
    "long_500k": {"seq_len": 128, "global_batch": 1, "pq_cache": True},
    "full_graph_sm": {"n_nodes": 64, "n_edges": 256, "d_feat": 1433},
    "minibatch_lg": {"n_nodes": 1000, "n_edges": 8000, "batch_nodes": 8,
                     "fanout": (15, 10), "d_feat": 602},
    "ogb_products": {"n_nodes": 128, "n_edges": 512, "d_feat": 100},
    "molecule": {"n_nodes": 30, "n_edges": 64, "batch": 4, "d_feat": 64},
    "train_batch": {"batch": 64},
    "serve_p99": {"batch": 16},
    "serve_bulk": {"batch": 32},
    "retrieval_cand": {"batch": 1, "n_candidates": 512},
}

#: DIN's retrieval scores candidates in chunks of this many (the JAX cell)
DIN_CHUNK = 31250


class Cell(NamedTuple):
    fn: Callable
    make_inputs: Callable
    meta: dict


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _opt_cfg_for(cfg) -> opt_lib.OptimizerConfig:
    """Over 50B parameters: Adafactor (a factored second moment, no first:
    AdamW's two parameter-sized moments do not fit), no global gradient
    clip (Adafactor's update-RMS clip takes its place), bf16 moment,
    compute and accumulation dtypes; AdamW in float32 with a clip of 1
    otherwise. lr 3e-4, GCD-G at lr 1e-3 on the rotations, and the
    config's own microbatch accumulation."""
    big, accum = False, 1
    if isinstance(cfg, tfm.TransformerConfig):
        big = tfm.num_params(cfg) > BIG_PARAMS
        accum = cfg.train_accum_steps
    half = torch.bfloat16 if big else torch.float32
    return opt_lib.OptimizerConfig(
        name="adafactor" if big else "adamw",
        grad_clip=0.0 if big else 1.0,
        lr=3e-4, moment_dtype=half, compute_dtype=half,
        accum_steps=accum, accum_dtype=half,
        rotation=rotations.RotationConfig(learner="gcd", method="greedy",
                                          lr=1e-3),
    )


def _randint(g, high: int, shape, dev, dtype=torch.int64):
    return torch.randint(0, high, shape, generator=g, device=dev,
                         dtype=dtype)


def _train_cell(loss_of, init_of, batch_of, full_cfg, meta: dict) -> Cell:
    """A train cell: ``loss_of(cfg)`` -> loss_fn(params, *batch),
    ``init_of(g, cfg, dev)`` -> the model, ``batch_of(cfg, batch, g, dev)``
    -> the batch tensors. The optimizer is ``_opt_cfg_for`` of the FULL
    config (a cut depth must not change it) at the run's accumulation."""
    ocfg = _opt_cfg_for(full_cfg)

    def fn(cfg, accum: int, marks=None):
        return ts.make_train_step(loss_of(cfg),
                                  ocfg._replace(accum_steps=accum),
                                  marks=marks)

    def make_inputs(cfg, batch: int, g, dev, accum: int):
        model = init_of(g, cfg, dev)
        state = ts.init_state(g, model, ocfg._replace(accum_steps=accum))
        return (state, *batch_of(cfg, batch * accum, g, dev))

    return Cell(fn=fn, make_inputs=make_inputs,
                meta=dict(meta, kind="train", optimizer=ocfg.name,
                          accum=int(ocfg.accum_steps)))


def _serve_cell(call_of, init_of, inputs_of, meta: dict, kind: str) -> Cell:
    """A serve cell: ``call_of(cfg)`` -> call(params, *inputs), run without
    autograd."""

    def fn(cfg, accum: int = 1, marks=None):
        call = call_of(cfg)

        def run(*args):
            with torch.no_grad():
                return call(*args)
        return run

    def make_inputs(cfg, batch: int, g, dev, accum: int = 1):
        with torch.no_grad():
            return (init_of(g, cfg, dev), *inputs_of(cfg, batch, g, dev))

    return Cell(fn=fn, make_inputs=make_inputs,
                meta=dict(meta, kind=kind, accum=1))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_init(g, cfg, dev, grad: bool):
    """Seeded parameters of ``tfm.param_specs(cfg)``, each leaf drawn in its
    own dtype in place: ``models.param.init_params`` draws in float32 and
    casts, and llama4's stacked MoE leaf of two layers (10.7e9 entries) is
    43 GB in float32 beside its 21 GB in bf16. The dry run needs random
    weights from a seed, not the launcher's."""
    def init(tree: dict) -> dict:
        out = {}
        for name in sorted(tree):
            spec = tree[name]
            if isinstance(spec, dict):
                out[name] = init(spec)
                continue
            t = torch.empty(spec.shape, dtype=spec.dtype or cfg.param_dtype,
                            device=dev)
            if spec.init in ("zeros", "ones"):
                t.fill_(1.0 if spec.init == "ones" else 0.0)
            elif spec.init == "eye":
                t.copy_(torch.eye(spec.shape[-1], device=dev).expand(
                    spec.shape))
            else:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else \
                    spec.shape[-1]
                t.normal_(0.0, spec.scale if spec.scale is not None
                          else fan_in ** -0.5, generator=g)
            out[name] = t.requires_grad_(grad)
        return out
    return init(tfm.param_specs(cfg))


def _lm_meta(cfg, shape: cbase.Shape, batch: int, flops: float) -> dict:
    return dict(model_flops=flops, batch=batch, batch_unit="sequences",
                depth=cfg.num_layers, seq_len=shape.params["seq_len"],
                cfg=cfg, family="lm")


def _lm_train_cell(cfg, shape: cbase.Shape) -> Cell:
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    A = cfg.train_accum_steps
    if B % A:
        raise ValueError(f"global batch {B} is not a multiple of the "
                         f"accumulation {A}")

    def batch_of(c, rows: int, g, dev):
        tok = _randint(g, c.vocab_size, (rows, S), dev)
        return tok, _randint(g, c.vocab_size, (rows, S), dev)

    return _train_cell(
        lambda c: (lambda p, tok, lab: tfm.forward_train(p, tok, lab, c)),
        lambda g, c, dev: _lm_init(g, c, dev, grad=True), batch_of, cfg,
        # 6N already covers forward and backward; remat re-runs the forward
        _lm_meta(cfg, shape, B // A,
                 tfm.model_flops_per_token(cfg) * B * S))


def _lm_decode_cell(cfg, shape: cbase.Shape) -> Cell:
    B, S = shape.params["global_batch"], shape.params["seq_len"]

    def inputs_of(c, b: int, g, dev):
        token = _randint(g, c.vocab_size, (b,), dev)
        cache = tfm.init_cache(c, b, S, device=dev)
        if isinstance(cache, tfm.PQDecodeCache):
            K = c.kv_quant.num_codewords
            for t in (cache.k_codes, cache.v_codes):
                for layer in t:           # a layer at a time: no int64 copy
                    layer.copy_(_randint(g, K, layer.shape, dev,
                                         torch.uint8))
        else:
            for t in (cache.k, cache.v):
                for layer in t:
                    layer.normal_(generator=g)
        # every position written but the last, where the token goes
        cache.length.fill_(S - 1)
        return token, cache

    # decode attention FLOPs: O(B·Hq·S·hd) a layer, plus the projections
    attn = (2.0 * B * cfg.num_heads * S * cfg.head_dim * 2) * cfg.num_layers
    return _serve_cell(
        lambda c: (lambda p, tok, cache: tfm.serve_decode(p, tok, cache,
                                                          c)),
        lambda g, c, dev: _lm_init(g, c, dev, grad=False), inputs_of,
        _lm_meta(cfg, shape, B,
                 tfm.model_flops_per_token(cfg) / 3.0 * B + attn),
        "decode")


def _lm_prefill_cell(cfg, shape: cbase.Shape) -> Cell:
    B, S = shape.params["global_batch"], shape.params["seq_len"]

    def inputs_of(c, b: int, g, dev):
        return (_randint(g, c.vocab_size, (b, S), dev),)

    # causal attention: 2 matmuls × B·Hq·S²/2·hd × 2 operations
    attn = (2.0 * B * cfg.num_heads * (S * S / 2) * cfg.head_dim * 2
            * cfg.num_layers)
    return _serve_cell(
        lambda c: (lambda p, tok: tfm.serve_prefill(p, tok, c, max_len=S)),
        lambda g, c, dev: _lm_init(g, c, dev, grad=False), inputs_of,
        _lm_meta(cfg, shape, B,
                 tfm.model_flops_per_token(cfg) / 3.0 * B * S + attn),
        "prefill")


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_init(g, cfg, dev):
    return gnn.GraphSAGE.init(g, cfg, device=dev)


def _gnn_meta(cfg, flops: float, batch: int, unit: str, **extra) -> dict:
    return dict(model_flops=flops, batch=batch, batch_unit=unit, depth=None,
                cfg=cfg, family="gnn", **extra)


def _gnn_full_cell(cfg, shape: cbase.Shape) -> Cell:
    # the JAX cell pads to twice its mesh's devices: one here
    N = _pad_to(shape.params["n_nodes"], 2)
    E = _pad_to(shape.params["n_edges"], 2)
    F = shape.params["d_feat"]

    def batch_of(c, n: int, g, dev):
        e = max(2, round(E * n / N))           # the graph cut to n nodes
        mask = torch.rand((n,), generator=g, device=dev) < 0.5
        return (torch.randn((n, F), generator=g, device=dev),
                _randint(g, n, (e,), dev), _randint(g, n, (e,), dev),
                _randint(g, c.num_classes, (n,), dev), mask)

    # SAGE FLOPs: 2 layers × N × (2 matmuls d_in·d_h) × 3 (fwd + bwd)
    flops = 3.0 * 2.0 * N * (F * cfg.d_hidden + cfg.d_hidden**2) * 2
    return _train_cell(
        lambda c: (lambda p, *b: gnn.loss_full_batch(p, *b, c)),
        _gnn_init, batch_of, cfg,
        _gnn_meta(cfg, flops, N, "nodes", edges=E))


def _gnn_minibatch_cell(cfg, shape: cbase.Shape) -> Cell:
    B = shape.params["batch_nodes"]
    f1, f2 = shape.params["fanout"]
    F = shape.params["d_feat"]

    def batch_of(c, b: int, g, dev):
        def h(*s):
            return torch.randn(s, generator=g, device=dev)
        return (h(b, F), h(b, f1, F), h(b, f1, f2, F),
                _randint(g, c.num_classes, (b,), dev))

    flops = 3.0 * 2.0 * B * (1 + f1) * (F * cfg.d_hidden + cfg.d_hidden**2) * 2
    return _train_cell(
        lambda c: (lambda p, h0, h1, h2, lab:
                   gnn.loss_minibatch(p, [h0, h1, h2], lab, c)),
        _gnn_init, batch_of, cfg, _gnn_meta(cfg, flops, B, "seed nodes"))


def _gnn_graph_batch_cell(cfg, shape: cbase.Shape) -> Cell:
    G = shape.params["batch"]
    n, e = shape.params["n_nodes"], shape.params["n_edges"]
    F = shape.params["d_feat"]
    N = G * n

    def batch_of(c, graphs: int, g, dev):
        base = torch.arange(graphs, device=dev).repeat_interleave(e) * n
        src = base + _randint(g, n, (graphs * e,), dev)
        dst = base + _randint(g, n, (graphs * e,), dev)
        gids = torch.arange(graphs, device=dev).repeat_interleave(n)
        return (torch.randn((graphs * n, F), generator=g, device=dev), src,
                dst, gids, _randint(g, c.num_classes, (graphs,), dev))

    flops = 3.0 * 2.0 * N * (F * cfg.d_hidden + cfg.d_hidden**2) * 2

    def loss_of(c):
        def loss(p, feats, src, dst, gids, labels):
            return gnn.loss_graph_batch(p, feats, src, dst, gids, labels,
                                        labels.shape[0], c)
        return loss
    return _train_cell(loss_of, _gnn_init, batch_of, cfg,
                       _gnn_meta(cfg, flops, G, "graphs"))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

_RECSYS = {recsys.WideDeepConfig: recsys.WideDeep,
           recsys.TwoTowerConfig: recsys.TwoTower,
           recsys.MINDConfig: recsys.MIND, recsys.DINConfig: recsys.DIN}


def _recsys_init(g, cfg, dev):
    return _RECSYS[type(cfg)].init(g, cfg, device=dev)


def _recsys_batch(cfg, B: int, g, dev) -> tuple:
    """One training batch of the architecture (the JAX cell's inputs)."""
    if isinstance(cfg, recsys.WideDeepConfig):
        return (_randint(g, cfg.vocab_per_field, (B, cfg.n_sparse), dev),
                (torch.rand((B,), generator=g, device=dev) < 0.5).float())
    hist = _randint(g, cfg.item_vocab, (B, cfg.hist_len), dev)
    item = _randint(g, cfg.item_vocab, (B,), dev)
    if isinstance(cfg, recsys.DINConfig):
        return (hist, item,
                (torch.rand((B,), generator=g, device=dev) < 0.5).float())
    return hist, item


def _recsys_loss(cfg) -> Callable:
    if isinstance(cfg, recsys.WideDeepConfig):
        return lambda p, ids, lab: recsys.widedeep_loss(p, ids, lab, cfg)
    if isinstance(cfg, recsys.TwoTowerConfig):
        return lambda p, h, pos: recsys.twotower_loss(p, h, pos, cfg)
    if isinstance(cfg, recsys.MINDConfig):
        return lambda p, h, pos: recsys.mind_loss(p, h, pos, cfg)
    if isinstance(cfg, recsys.DINConfig):
        return lambda p, h, t, lab: recsys.din_loss(p, h, t, lab, cfg)
    raise TypeError(type(cfg))


def _recsys_flops(cfg, B: int) -> float:
    if isinstance(cfg, recsys.WideDeepConfig):
        dims = (cfg.n_sparse * cfg.embed_dim, *cfg.mlp_dims, 1)
        return B * 2.0 * sum(a * b for a, b in zip(dims, dims[1:]))
    if isinstance(cfg, recsys.TwoTowerConfig):
        dims = (cfg.embed_dim, *cfg.tower_dims)
        return 2 * B * 2.0 * sum(a * b for a, b in zip(dims, dims[1:]))
    if isinstance(cfg, recsys.MINDConfig):
        e = cfg.embed_dim
        return B * 2.0 * (cfg.hist_len * e * e
                          + cfg.capsule_iters * cfg.hist_len * cfg.n_interests * e
                          + cfg.n_interests * 8 * e * e)
    if isinstance(cfg, recsys.DINConfig):
        e = cfg.embed_dim
        a = (4 * e, *cfg.attn_dims, 1)
        h = (2 * e, *cfg.mlp_dims, 1)
        return B * 2.0 * (cfg.hist_len * sum(x * y for x, y in zip(a, a[1:]))
                          + sum(x * y for x, y in zip(h, h[1:])))
    raise TypeError(type(cfg))


def _recsys_meta(cfg, flops: float, batch: int, unit: str) -> dict:
    return dict(model_flops=flops, batch=batch, batch_unit=unit, depth=None,
                cfg=cfg, family="recsys")


def _recsys_train_cell(cfg, shape: cbase.Shape) -> Cell:
    B = shape.params["batch"]
    return _train_cell(
        _recsys_loss, _recsys_init,
        lambda c, b, g, dev: _recsys_batch(c, b, g, dev), cfg,
        _recsys_meta(cfg, 3.0 * _recsys_flops(cfg, B), B, "rows"))


def _recsys_serve_call(cfg) -> Callable:
    if isinstance(cfg, recsys.WideDeepConfig):
        return lambda p, ids, _labels: recsys.widedeep_forward(p, ids, cfg)
    if isinstance(cfg, recsys.TwoTowerConfig):
        def call(p, hist, item):
            u = recsys.user_tower(p, hist, cfg)
            v, _ = recsys.item_tower(p, item, cfg, apply_index=True)
            return torch.sum(u * v, dim=-1)
        return call
    if isinstance(cfg, recsys.MINDConfig):
        def call(p, hist, item):
            u = recsys.mind_interests(p, hist, cfg)
            v = embedding.lookup(p.item_table, item).to(u.dtype)
            return torch.amax(torch.einsum("bie,be->bi", u, v), dim=-1)
        return call
    if isinstance(cfg, recsys.DINConfig):
        return lambda p, hist, target, _labels: recsys.din_forward(
            p, hist, target, cfg)
    raise TypeError(type(cfg))


def _recsys_serve_cell(cfg, shape: cbase.Shape) -> Cell:
    B = shape.params["batch"]
    return _serve_cell(_recsys_serve_call, _recsys_init,
                       lambda c, b, g, dev: _recsys_batch(c, b, g, dev),
                       _recsys_meta(cfg, _recsys_flops(cfg, B), B, "rows"),
                       "serve")


def _recsys_retrieval_cell(cfg, shape: cbase.Shape) -> Cell:
    N = shape.params["n_candidates"]
    if isinstance(cfg, recsys.TwoTowerConfig):
        D = cfg.index.num_subspaces

        # the paper's serving path: ADC over the PQ codes of the corpus
        def call_of(c):
            return lambda p, hist, codes: recsys.twotower_retrieve_adc(
                p, hist, codes, c)

        def inputs_of(c, n, g, dev):
            return (_randint(g, c.item_vocab, (1, c.hist_len), dev),
                    _randint(g, c.index.num_codewords,
                             (n, c.index.num_subspaces), dev, torch.uint8))
        flops = N * D * 2.0            # the table gather-adds
    elif isinstance(cfg, recsys.MINDConfig):
        def call_of(c):
            return lambda p, hist, vecs: recsys.mind_retrieve(p, hist, vecs,
                                                              c)

        def inputs_of(c, n, g, dev):
            return (_randint(g, c.item_vocab, (1, c.hist_len), dev),
                    torch.randn((n, c.embed_dim), generator=g, device=dev))
        flops = N * cfg.embed_dim * cfg.n_interests * 2.0
    elif isinstance(cfg, recsys.DINConfig):
        def call_of(c):
            return lambda p, hist, cands: recsys.din_score_candidates(
                p, hist, cands, c, chunk=min(DIN_CHUNK, cands.shape[0]))

        def inputs_of(c, n, g, dev):
            return (_randint(g, c.item_vocab, (c.hist_len,), dev),
                    _randint(g, c.item_vocab, (n,), dev))
        flops = _recsys_flops(cfg, N)
    elif isinstance(cfg, recsys.WideDeepConfig):
        def call_of(c):
            return lambda p, ids: recsys.widedeep_forward(p, ids, c)

        def inputs_of(c, n, g, dev):
            return (_randint(g, c.vocab_per_field, (n, c.n_sparse), dev),)
        flops = _recsys_flops(cfg, N)
    else:
        raise TypeError(type(cfg))
    return _serve_cell(call_of, _recsys_init, inputs_of,
                       _recsys_meta(cfg, flops, N, "candidates"),
                       "retrieval")


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def smoke_config(arch_id: str, shape_name: str):
    """The architecture's ``make_smoke`` config adjusted to the shape as the
    full one is; a PQ KV cache sized for the full head width is resized to
    the smoke head (KVQuantConfig(head_dim, 4, 16))."""
    arch = configs.get(arch_id)
    cfg = arch.make_smoke()
    if arch.adjust is not None:
        cfg = arch.adjust(cfg, shape_name)
    kq = getattr(cfg, "kv_quant", None)
    if kq is not None and kq.head_dim != cfg.head_dim:
        cfg = cfg._replace(kv_quant=KVQuantConfig(cfg.head_dim, 4, 16))
    return cfg


def build_cell(arch_id: str, shape_name: str, *, smoke: bool = False
               ) -> Cell:
    """The cell's step, its input maker and ``meta``; ``smoke`` for the
    architecture's smoke config at ``SMOKE_SHAPES``' sizes."""
    arch = configs.get(arch_id)
    shape = arch.shapes[shape_name]
    if smoke:
        shape = shape._replace(params=SMOKE_SHAPES[shape_name])
        cfg = smoke_config(arch_id, shape_name)
    else:
        cfg = arch.config_for_shape(shape_name)
    builders = {
        ("lm", "train"): _lm_train_cell,
        ("lm", "prefill"): _lm_prefill_cell,
        ("lm", "decode"): _lm_decode_cell,
        ("gnn", "gnn_full"): _gnn_full_cell,
        ("gnn", "gnn_minibatch"): _gnn_minibatch_cell,
        ("gnn", "gnn_graph_batch"): _gnn_graph_batch_cell,
        ("recsys", "recsys_train"): _recsys_train_cell,
        ("recsys", "recsys_serve"): _recsys_serve_cell,
        ("recsys", "recsys_retrieval"): _recsys_retrieval_cell,
    }
    build = builders.get((arch.family, shape.kind))
    if build is None:
        raise ValueError(f"no builder for {arch_id}/{shape_name} "
                         f"({shape.kind})")
    cell = build(cfg, shape)
    cell.meta.update(arch=arch_id, shape=shape_name, shape_kind=shape.kind,
                     shape_params=dict(shape.params), smoke=smoke)
    return cell


def at_depth(cfg: Any, depth: int | None):
    """The config with ``depth`` layers (the interleave's pairs kept), or
    as it is for ``None`` and for a config without layers to cut."""
    if depth is None or not isinstance(cfg, tfm.TransformerConfig):
        return cfg
    if cfg.interleaved and depth % 2:
        raise ValueError(f"{cfg.name}: depth {depth} breaks the dense/MoE "
                         "interleave")
    return cfg._replace(num_layers=int(depth))


def num_params(cfg) -> int:
    """Parameters of a config of any family (the index layer included)."""
    if isinstance(cfg, tfm.TransformerConfig):
        return tfm.num_params(cfg)
    if isinstance(cfg, gnn.GraphSAGEConfig):
        return param.count_params(gnn.param_specs(cfg))
    specs = {recsys.WideDeepConfig: recsys.widedeep_specs,
             recsys.TwoTowerConfig: recsys.twotower_specs,
             recsys.MINDConfig: recsys.mind_specs,
             recsys.DINConfig: recsys.din_specs}[type(cfg)](cfg)
    n = param.count_params(specs)
    if isinstance(cfg, recsys.TwoTowerConfig) and cfg.index is not None:
        d, D = cfg.index.dim, cfg.index.num_subspaces
        n += d * d + D * cfg.index.num_codewords * (d // D)
    return n

