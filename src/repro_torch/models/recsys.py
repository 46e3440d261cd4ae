"""The RecSys model zoo (port of ``repro/models/recsys.py``): Wide&Deep,
the paper's two-tower retrieval model, MIND and DIN.

  wide-deep    concat + deep MLP ∥ wide linear           (ranking, BCE)
  two-tower    dot(user MLP, item MLP), in-batch hinge   (retrieval — the
               paper's own setting; index layer on the item tower)
  mind         capsule dynamic routing → interests, max over interests
  din          target attention over the user history → MLP (ranking, BCE)

The rankers gather their tables with ``embedding.lookup`` (a plain gather,
a dense gradient), as the JAX package does with ``jnp.take``. Wide&Deep's
``psum_lookup=True`` takes the mesh explicitly (``WideDeep.init(...,
mesh=)``, ``widedeep_forward(..., mesh)``): its tables are placed over
the mesh's "model" axis and read by ``embedding.sharded_lookup``, the JAX
package's masked psum lookup.

Two-tower: a user tower (EmbeddingBag over the click history, then an MLP) and an
item tower (embedding lookup, then an MLP, then the trainable index layer
T(X) = φ(XR)Rᵀ) are scored by cosine similarity and trained with the
in-batch hinge loss (paper §3.2, margin 0.1) plus the distortion term of
Eq. 1. ``TwoTower`` is an ``nn.Module`` whose parameter names are the JAX
leaf names: ``item_table``, ``user{i}_w``/``_b``, ``item{i}_w``/``_b``,
``index.R``, ``index.codebooks``. ``WideDeep``, ``MIND`` and ``DIN`` are
``models.param.Params`` modules under the JAX leaf names too (``table``,
``wide``, ``mlp{i}_w``; ``item_table``, ``bilinear``, ``interest{i}_w``;
``item_table``, ``attn{i}_w``, ``head{i}_w``). MIND's routing runs its
``capsule_iters`` iterations as a loop where the JAX package scans.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core import index_layer as il
from repro_torch.models import embedding, param
from repro_torch.models.param import ParamSpec
from repro_torch.sharding import placed as pl
from repro_torch.sharding import rules as sh


def _mlp_specs(dims: tuple[int, ...], prefix: str = "mlp"):
    specs = {}
    for i in range(len(dims) - 1):
        specs[f"{prefix}{i}_w"] = ParamSpec((dims[i], dims[i + 1]),
                                            ("w_in", "w_hidden"))
        specs[f"{prefix}{i}_b"] = ParamSpec((dims[i + 1],), ("w_hidden",),
                                            init="zeros")
    return specs


def _mlp_apply(params, x: torch.Tensor, dims: tuple[int, ...],
               prefix: str = "mlp", final_act: bool = False) -> torch.Tensor:
    n = len(dims) - 1
    for i in range(n):
        x = x @ getattr(params, f"{prefix}{i}_w") + getattr(
            params, f"{prefix}{i}_b")
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Mean binary cross-entropy, the JAX package's stable form."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class _Model(param.Params):
    """A ranker's parameters, drawn from its ``specs`` function."""

    specs: Any = None

    @classmethod
    def init(cls, generator: torch.Generator, cfg, *, device=None):
        """Fresh parameters on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return cls(param.init_params(generator, cls.specs(cfg),
                                     cfg.param_dtype, device=dev))


# ===========================================================================
# Wide & Deep
# ===========================================================================

class WideDeepConfig(NamedTuple):
    name: str = "wide-deep"
    n_sparse: int = 40
    vocab_per_field: int = 1_000_000
    embed_dim: int = 32
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    psum_lookup: bool = False        # masked psum lookup over a mesh
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    rules: str = "recsys"

    @property
    def rule_table(self) -> dict:
        return sh.RULE_REGISTRY[self.rules]

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field


def widedeep_specs(cfg: WideDeepConfig) -> dict[str, ParamSpec]:
    d_in = cfg.n_sparse * cfg.embed_dim
    dims = (d_in, *cfg.mlp_dims, 1)
    return {
        # one fused table; field f owns rows [f·V, (f+1)·V)
        "table": ParamSpec((cfg.total_vocab, cfg.embed_dim),
                           ("vocab_rows", "w_embed_dim"), scale=0.01),
        "wide": ParamSpec((cfg.total_vocab, 1), ("vocab_rows", None),
                          scale=0.01),
        **_mlp_specs(dims),
    }


def _need_mesh(cfg: WideDeepConfig, mesh, what: str) -> None:
    if cfg.psum_lookup and mesh is None:
        raise ValueError(f"{what}: psum_lookup=True needs the mesh its "
                         "table is placed on (mesh=None)")


class WideDeep(_Model):
    """With ``cfg.psum_lookup`` the model lives on ``mesh``: its
    ``vocab_rows`` leaves (``table`` and ``wide``) are ``Placed`` by
    ``tree_shardings(widedeep_specs, cfg.rule_table, mesh)``, rows over
    "model", and the MLP stays whole on ``mesh.devices[0]``."""

    specs = staticmethod(widedeep_specs)

    @classmethod
    def init(cls, generator: torch.Generator, cfg, *, device=None,
             mesh=None):
        """Fresh parameters on ``device`` (the card by default), or on
        ``mesh`` (needed by, and only by, ``psum_lookup=True``): the same
        draws, then the table and ``wide`` placed."""
        _need_mesh(cfg, mesh, "WideDeep.init")
        if mesh is None:
            return super().init(generator, cfg, device=device)
        if not cfg.psum_lookup:
            raise ValueError("WideDeep.init: a mesh places the tables of "
                             "psum_lookup=True only")
        return super().init(generator, cfg,
                            device=mesh.devices[0]).place(cfg, mesh)

    def place(self, cfg, mesh) -> "WideDeep":
        """Lay every ``vocab_rows`` leaf over ``mesh`` (in place)."""
        specs = widedeep_specs(cfg)
        names = [k for k in sorted(specs) if "vocab_rows" in specs[k].logical]
        shardings = sh.tree_shardings(
            {k: specs[k].logical for k in names}, cfg.rule_table, mesh,
            {k: specs[k].shape for k in names})
        for k in names:
            leaf = self._parameters.pop(k)
            self.add_module(k, pl.place(leaf, shardings[k]))
            del leaf
        return self


def widedeep_forward(params: WideDeep, sparse_ids: torch.Tensor,
                     cfg: WideDeepConfig, mesh=None) -> torch.Tensor:
    """sparse_ids (B, n_sparse) field-local ids -> logits (B,). With
    ``cfg.psum_lookup`` both tables are read by
    ``embedding.sharded_lookup`` over ``mesh``'s "model" axis (the JAX
    package reads its ambient mesh), and the logits land on
    ``mesh.devices[0]``."""
    _need_mesh(cfg, mesh, "widedeep_forward")
    rt = cfg.rule_table
    B, F = sparse_ids.shape
    offsets = torch.arange(F, device=sparse_ids.device) * cfg.vocab_per_field
    gids = sparse_ids.long() + offsets[None, :]
    if cfg.psum_lookup:
        def lookup(t, i):
            return embedding.sharded_lookup(t, i, mesh, "model")
    else:
        lookup = embedding.lookup
    emb = lookup(params.table, gids)                           # (B, F, e)
    emb = sh.constrain(emb, ("act_batch", "fields", None), rt, mesh)
    deep_in = emb.reshape(B, F * cfg.embed_dim).to(cfg.dtype)
    d_in = F * cfg.embed_dim
    deep = _mlp_apply(params, deep_in, (d_in, *cfg.mlp_dims, 1))[:, 0]
    wide = torch.sum(lookup(params.wide, gids)[..., 0], dim=-1)
    return deep + wide.to(deep.dtype)


def widedeep_loss(params: WideDeep, sparse_ids: torch.Tensor,
                  labels: torch.Tensor, cfg: WideDeepConfig,
                  mesh=None) -> torch.Tensor:
    logits = widedeep_forward(params, sparse_ids, cfg, mesh).float()
    return _bce_with_logits(logits, labels)


# ===========================================================================
# Two-tower retrieval (the paper's own setting)
# ===========================================================================

class TwoTowerConfig(NamedTuple):
    name: str = "two-tower-retrieval"
    item_vocab: int = 10_000_000
    embed_dim: int = 256
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    hist_len: int = 50
    scoring: str = "cosine"           # cosine | dot
    hinge_margin: float = 0.1
    index: il.IndexLayerConfig | None = None  # index layer on the item tower
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    rules: str = "recsys"

    @property
    def rule_table(self) -> dict:
        return sh.RULE_REGISTRY[self.rules]

    @property
    def out_dim(self) -> int:
        return self.tower_dims[-1]


def twotower_specs(cfg: TwoTowerConfig) -> dict[str, ParamSpec]:
    e = cfg.embed_dim
    return {
        "item_table": ParamSpec((cfg.item_vocab, e),
                                ("vocab_rows", "w_embed_dim"), scale=0.01),
        **_mlp_specs((e, *cfg.tower_dims), prefix="user"),
        **_mlp_specs((e, *cfg.tower_dims), prefix="item"),
    }


class TwoTower(nn.Module):
    """The model's parameters; the functions below take it as ``params``.
    ``index`` is the ``IndexLayer`` submodule, or None until one is
    attached (``TwoTower.init`` attaches a fresh one when ``cfg.index`` is
    set, as ``twotower_init`` does)."""

    def __init__(self, tensors: dict[str, torch.Tensor],
                 index: il.IndexLayer | None = None):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))
        self.index = index

    @classmethod
    def init(cls, generator: torch.Generator, cfg: TwoTowerConfig, *,
             device=None) -> "TwoTower":
        """Fresh parameters on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        tensors = param.init_params(generator, twotower_specs(cfg),
                                    cfg.param_dtype, device=dev)
        index = None
        if cfg.index is not None:
            index = il.init(generator, cfg.index, dtype=cfg.param_dtype,
                            device=dev)
        return cls(tensors, index)


def user_tower(params: TwoTower, hist_ids: torch.Tensor,
               cfg: TwoTowerConfig) -> torch.Tensor:
    """hist_ids (B, L), −1 padded -> (B, out): the mean of the history's
    item embeddings (embedding_bag kernel), then the user MLP."""
    pooled = embedding.bag_lookup(params.item_table, hist_ids,
                                  combiner="mean")
    return _mlp_apply(params, pooled.to(cfg.dtype),
                      (cfg.embed_dim, *cfg.tower_dims), prefix="user")


def item_tower(params: TwoTower, item_ids: torch.Tensor, cfg: TwoTowerConfig,
               apply_index: bool = False):
    """item_ids (B,) -> ((B, out), distortion); the distortion is 0 unless
    the index layer is applied."""
    emb = embedding.lookup(params.item_table, item_ids)
    v = _mlp_apply(params, emb.to(cfg.dtype),
                   (cfg.embed_dim, *cfg.tower_dims), prefix="item")
    if apply_index and params.index is not None:
        return il.apply(params.index, v)
    return v, torch.zeros((), dtype=torch.float32, device=v.device)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def _score(u: torch.Tensor, v: torch.Tensor, scoring: str) -> torch.Tensor:
    if scoring == "cosine":
        u, v = _normalize(u), _normalize(v)
    return u @ v.T


def twotower_loss(params: TwoTower, hist_ids: torch.Tensor,
                  pos_item_ids: torch.Tensor, cfg: TwoTowerConfig,
                  use_index: bool = True) -> torch.Tensor:
    """In-batch hinge loss (paper §3.2: cosine scoring, margin 0.1), plus
    the distortion term when the index layer is attached (Eq. 1). The
    (B, B) score matrix is the largest temporary: 1.07 GB at B = 16,384."""
    u = user_tower(params, hist_ids, cfg)
    v, dist = item_tower(params, pos_item_ids, cfg, apply_index=use_index)
    scores = _score(u, v, cfg.scoring).float()                 # (B, B)
    B = scores.shape[0]
    pos = torch.diagonal(scores)
    hinge = torch.clamp((cfg.hinge_margin + scores) - pos[:, None], min=0.0)
    torch.diagonal(hinge).zero_()          # in place: no (B, B) mask
    loss = torch.sum(hinge) * (1.0 / (float(B) * (B - 1.0)))
    if use_index and params.index is not None:
        loss = loss + cfg.index.distortion_weight * dist
    return loss


def twotower_retrieve_dense(params: TwoTower, hist_ids: torch.Tensor,
                            cand_vecs: torch.Tensor,
                            cfg: TwoTowerConfig) -> torch.Tensor:
    """Dense baseline: (B, L) histories vs (N, out) candidate vectors."""
    u = user_tower(params, hist_ids, cfg)
    return _score(u, cand_vecs, cfg.scoring)


def twotower_retrieve_adc(params: TwoTower, hist_ids: torch.Tensor,
                          cand_codes: torch.Tensor,
                          cfg: TwoTowerConfig) -> torch.Tensor:
    """The paper's serving path: ADC over the PQ codes of the corpus,
    (B, L) histories × (N, D) codes -> (B, N), through adc_lookup."""
    u = user_tower(params, hist_ids, cfg)
    if cfg.scoring == "cosine":
        u = _normalize(u)
    return il.adc_scores(params.index, u, cand_codes)


# ===========================================================================
# MIND — multi-interest capsule routing
# ===========================================================================

class MINDConfig(NamedTuple):
    name: str = "mind"
    item_vocab: int = 2_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    rules: str = "recsys"

    @property
    def rule_table(self) -> dict:
        return sh.RULE_REGISTRY[self.rules]


def mind_specs(cfg: MINDConfig) -> dict[str, ParamSpec]:
    e = cfg.embed_dim
    return {
        "item_table": ParamSpec((cfg.item_vocab, e),
                                ("vocab_rows", "w_embed_dim"), scale=0.01),
        "bilinear": ParamSpec((e, e), ("w_in", "w_hidden")),  # S (B2I routing)
        **_mlp_specs((e, 4 * e, e), prefix="interest"),       # per interest
    }


class MIND(_Model):
    specs = staticmethod(mind_specs)


def _squash(s: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(torch.square(s), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


def mind_interests(params: MIND, hist_ids: torch.Tensor,
                   cfg: MINDConfig) -> torch.Tensor:
    """Dynamic routing (B2I): hist (B, L), −1 padded -> interests (B, I, e).
    The routing logits start at 0 and take ``capsule_iters`` updates; the
    last iteration's capsules go through the interest MLP."""
    B, L = hist_ids.shape
    valid = hist_ids >= 0
    e = embedding.lookup(params.item_table, torch.clamp(hist_ids, min=0))
    e = torch.where(valid[..., None], e, 0.0).to(cfg.dtype)    # (B, L, e)
    eS = (e @ params.bilinear.to(e.dtype)).float()     # behaviour→interest
    b = torch.zeros((B, L, cfg.n_interests), dtype=torch.float32,
                    device=hist_ids.device)                      # logits
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1)                             # over I
        w = torch.where(valid[..., None], w, 0.0)
        s = torch.einsum("bli,ble->bie", w, eS)
        u = _squash(s)                                           # (B, I, e)
        b = b + torch.einsum("ble,bie->bli", eS, u)
    return _mlp_apply(params, u.to(cfg.dtype),
                      (cfg.embed_dim, 4 * cfg.embed_dim, cfg.embed_dim),
                      prefix="interest")


def mind_loss(params: MIND, hist_ids: torch.Tensor,
              pos_item_ids: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
    """Max over interests, then the in-batch softmax. The (B, I, B)
    float32 scores are the largest temporary: 4.3 GB at B = 16,384, 68.7
    GB at the recsys train_batch of 65,536."""
    u = mind_interests(params, hist_ids, cfg)                   # (B, I, e)
    v = embedding.lookup(params.item_table, pos_item_ids).to(cfg.dtype)
    att = torch.einsum("bie,ce->bic", u, v).float()             # (B, I, B)
    scores = torch.amax(att, dim=1)          # ties share the gradient, as
    logp = torch.log_softmax(scores, dim=-1)  # jnp.max's do
    return -torch.mean(torch.diagonal(logp))


def mind_retrieve(params: MIND, hist_ids: torch.Tensor,
                  cand_vecs: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
    """(B, L) histories × (N, e) candidates -> (B, N): the max over
    interests of the dot scores."""
    u = mind_interests(params, hist_ids, cfg)
    return torch.amax(torch.einsum("bie,ne->bin", u,
                                   cand_vecs.to(u.dtype)), dim=1)


# ===========================================================================
# DIN — deep interest network (target attention)
# ===========================================================================

class DINConfig(NamedTuple):
    name: str = "din"
    item_vocab: int = 1_000_000
    embed_dim: int = 18
    hist_len: int = 100
    attn_dims: tuple[int, ...] = (80, 40)
    mlp_dims: tuple[int, ...] = (200, 80)
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    rules: str = "recsys"

    @property
    def rule_table(self) -> dict:
        return sh.RULE_REGISTRY[self.rules]


def din_specs(cfg: DINConfig) -> dict[str, ParamSpec]:
    e = cfg.embed_dim
    return {
        "item_table": ParamSpec((cfg.item_vocab, e),
                                ("vocab_rows", "w_embed_dim"), scale=0.01),
        **_mlp_specs((4 * e, *cfg.attn_dims, 1), prefix="attn"),
        **_mlp_specs((2 * e, *cfg.mlp_dims, 1), prefix="head"),
    }


class DIN(_Model):
    specs = staticmethod(din_specs)


def din_forward(params: DIN, hist_ids: torch.Tensor, target_ids: torch.Tensor,
                cfg: DINConfig) -> torch.Tensor:
    """hist (B, L), −1 padded, target (B,) -> logits (B,). Target
    attention: the attention MLP sees [h, t, h − t, h ⊙ t] for each history
    item (DIN eq. 3); padded items are masked with −1e30, so a history with
    no item pools zeros under uniform weights (no NaN)."""
    e = cfg.embed_dim
    valid = hist_ids >= 0
    h = embedding.lookup(params.item_table,
                         torch.clamp(hist_ids, min=0)).to(cfg.dtype)
    h = torch.where(valid[..., None], h, 0.0)                   # (B, L, e)
    t = embedding.lookup(params.item_table, target_ids).to(cfg.dtype)
    tt = t[:, None].expand_as(h)
    attn_in = torch.cat([h, tt, h - tt, h * tt], dim=-1)        # (B, L, 4e)
    w = _mlp_apply(params, attn_in, (4 * e, *cfg.attn_dims, 1),
                   prefix="attn")[..., 0]
    w = torch.where(valid, w, -1e30)
    w = torch.softmax(w.float(), dim=-1).to(cfg.dtype)
    pooled = torch.einsum("bl,ble->be", w, h)
    head_in = torch.cat([pooled, t], dim=-1)
    return _mlp_apply(params, head_in, (2 * e, *cfg.mlp_dims, 1),
                      prefix="head")[:, 0]


def din_loss(params: DIN, hist_ids: torch.Tensor, target_ids: torch.Tensor,
             labels: torch.Tensor, cfg: DINConfig) -> torch.Tensor:
    logits = din_forward(params, hist_ids, target_ids, cfg).float()
    return _bce_with_logits(logits, labels)


def din_score_candidates(params: DIN, hist_ids: torch.Tensor,
                         cand_ids: torch.Tensor, cfg: DINConfig,
                         chunk: int = 8192) -> torch.Tensor:
    """Target-attention scores of N candidates for ONE user: hist (L,),
    cand (N,) -> (N // chunk · chunk,), a chunk of candidates at a time
    (no N × L temporary beyond chunk × L). As in the JAX package, the
    candidates past the last whole chunk are not scored."""
    nc = cand_ids.shape[0] // chunk
    hist_b = hist_ids[None].expand(chunk, hist_ids.shape[0])
    out = [din_forward(params, hist_b, cand_ids[i * chunk:(i + 1) * chunk],
                       cfg) for i in range(nc)]
    if not out:
        return torch.zeros((0,), dtype=cfg.dtype, device=cand_ids.device)
    return torch.cat(out)
