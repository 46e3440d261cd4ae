"""The two-tower retrieval model of the paper (port of the two-tower part of
``repro/models/recsys.py:30-45, 119-221``; Wide&Deep, MIND and DIN wait).

A user tower (EmbeddingBag over the click history, then an MLP) and an
item tower (embedding lookup, then an MLP, then the trainable index layer
T(X) = φ(XR)Rᵀ) are scored by cosine similarity and trained with the
in-batch hinge loss (paper §3.2, margin 0.1) plus the distortion term of
Eq. 1. ``TwoTower`` is an ``nn.Module`` whose parameter names are the JAX
leaf names: ``item_table``, ``user{i}_w``/``_b``, ``item{i}_w``/``_b``,
``index.R``, ``index.codebooks``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core import index_layer as il
from repro_torch.models import embedding, param
from repro_torch.models.param import ParamSpec


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
