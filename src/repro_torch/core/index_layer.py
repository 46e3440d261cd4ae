"""The paper's trainable embedding-index layer T(X) = φ(X·R)·Rᵀ (§2.1),
port of ``repro/core/index_layer.py``.

It sits at the top of the item tower of the two-tower retrieval model.
The forward rotates the batch into the PQ basis, quantizes it with a
straight-through estimator and rotates back, so the retrieval loss sees
what the serving index returns; the loss adds the distortion
(1/m)‖XR − φ(XR)‖² (Eq. 1).

``IndexLayer`` is an ``nn.Module`` with two parameters: ``R``, which the
trainer routes to its rotation learner (GCD) instead of AdamW, and
``codebooks`` (D, K, sub), trained by the distortion term. On the card each
forward assigns codes twice through the pq_assign kernel (``encode_st`` and
``distortion``, as the JAX package does); serving scores through the
adc_lookup kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.kernels import ops as kops
from repro_torch.quant import opq
from repro_torch.quant.base import PQConfig
from repro_torch.quant.pq import PQ


class IndexLayerConfig(NamedTuple):
    dim: int
    num_subspaces: int = 8
    num_codewords: int = 256
    distortion_weight: float = 1.0

    @property
    def pq_cfg(self) -> PQConfig:
        return PQConfig(self.num_subspaces, self.num_codewords)


class IndexLayer(nn.Module):
    """The layer's parameters: ``R`` (n, n) and ``codebooks`` (D, K, sub).
    The functions below take it as their first argument, as the JAX
    package's take ``IndexLayerParams``."""

    def __init__(self, R: torch.Tensor, codebooks: torch.Tensor):
        super().__init__()
        self.R = nn.Parameter(R)
        self.codebooks = nn.Parameter(codebooks)


def quantizer(layer: IndexLayer) -> PQ:
    """The layer's φ as a protocol object over the codebook leaf."""
    return PQ(layer.codebooks)


def init(generator: torch.Generator, cfg: IndexLayerConfig,
         dtype=torch.float32, device=None) -> IndexLayer:
    """R = I and codebooks 0.01·N(0, 1), on ``device`` (the card by
    default; ``generator`` must live there)."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    sub = cfg.dim // cfg.num_subspaces
    cb = 0.01 * torch.randn((cfg.num_subspaces, cfg.num_codewords, sub),
                            generator=generator, dtype=dtype, device=dev)
    return IndexLayer(torch.eye(cfg.dim, dtype=dtype, device=dev), cb)


def warm_start(generator: torch.Generator, X: torch.Tensor,
               cfg: IndexLayerConfig, opq_iters: int = 200,
               kmeans_iters: int = 1) -> IndexLayer:
    """Paper §3.2: OPQ on a warm-up sample X initialises R and the codebooks
    before joint training starts."""
    with torch.no_grad():
        R, pq, _ = opq.fit(generator, X.detach(), cfg.pq_cfg,
                           iters=opq_iters, kmeans_iters=kmeans_iters)
    return IndexLayer(R.contiguous(), pq.codebooks.contiguous())


def apply(layer: IndexLayer,
          X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(T(X), distortion) with the straight-through estimator. ∂/∂X flows
    through φ and both rotations; ∂/∂codebooks comes from the distortion
    term; ∂/∂R goes to the rotation learner."""
    phi = quantizer(layer)
    XR = X @ layer.R
    out = phi.encode_st(XR) @ layer.R.T
    return out, phi.distortion(XR)


def apply_no_ste(layer: IndexLayer, X: torch.Tensor) -> torch.Tensor:
    """Serving-path forward: hard quantization, no gradient bridging."""
    phi = quantizer(layer)
    return phi.decode(phi.encode(X @ layer.R)) @ layer.R.T


def encode(layer: IndexLayer, X: torch.Tensor) -> torch.Tensor:
    """Index-build path: item codes (m, D) int32."""
    return quantizer(layer).encode(X @ layer.R)


def adc_scores(layer: IndexLayer, queries: torch.Tensor,
               codes: torch.Tensor) -> torch.Tensor:
    """(b, n) queries × (N, D) codes -> (b, N) inner-product scores through
    the adc_lookup kernel: ⟨q, φ(xR)Rᵀ⟩ = ⟨qR, φ(xR)⟩ since R is
    orthogonal. Codes are narrowed to the storage dtype (uint8 up to 256
    codewords) unless they already have it."""
    phi = quantizer(layer)
    tables = phi.adc_tables(queries @ layer.R).contiguous()
    return kops.adc_lookup(tables, codes.to(phi.code_dtype).contiguous())
