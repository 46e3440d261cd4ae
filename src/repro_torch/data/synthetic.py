"""Synthetic data (port of ``repro/data/synthetic.py``: ``sift_like`` and
the ``ClickLog`` of the two-tower experiments).

A torch generator draws other numbers than a JAX key of the same seed, so
the port's vectors match the JAX package's in distribution only. The click
log's batches are drawn with numpy's ``RandomState`` exactly as the JAX
package draws them, so given the same item vectors both give the same ids.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as _device


def sift_like(generator: torch.Generator, num: int, dim: int,
              num_clusters: int = 16, anisotropy: float = 8.0, *,
              device=None) -> torch.Tensor:
    """Gaussian mixture with per-cluster anisotropic covariance, (num, dim)
    float32 on ``device`` (the card by default; ``generator`` must live
    there). Each cluster has a random orthogonal basis times log-spaced
    scales, like real SIFT's correlated coordinates.

    Rows are rotated cluster by cluster, one matmul each: the JAX version's
    per-row einsum against ``qs[assign]`` would hold a (num, dim, dim)
    tensor, 262 GB at num = 1M and dim = 256."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    kw = dict(generator=generator, device=dev)
    means = 4.0 * torch.randn((num_clusters, dim), **kw)
    u = torch.rand((num_clusters, dim), **kw) - 0.5
    scales = torch.exp(math.log(anisotropy) * u)
    qs, _ = torch.linalg.qr(torch.randn((num_clusters, dim, dim), **kw))
    assign = torch.randint(0, num_clusters, (num,), **kw)
    z = torch.randn((num, dim), **kw)
    out = torch.empty_like(z)
    for c in range(num_clusters):
        rows = torch.nonzero(assign == c).squeeze(1)
        out[rows] = (z[rows] * scales[c]) @ qs[c] + means[c]
    return out


class ClickLog:
    """Latent-factor click generator (port of
    ``repro/data/synthetic.py:59-119``).

    Items live in a latent space with anisotropic structure; a user's
    history is the items nearest a popularity-drawn anchor item among 64
    random proposals, the label the nearest of all. Popularity is zipf.

    ``item_vecs`` (num_items, dim) are the log's unit-norm item vectors: by
    default ``sift_like`` on ``device`` (the card by default) from ``seed``,
    normalised; or given as numpy (for example a JAX ClickLog's
    ``item_vecs``), taken as they are. They are kept on the host for the
    numpy batch draws."""

    def __init__(self, seed: int, num_items: int, dim: int = 32,
                 num_clusters: int = 64, *, item_vecs: np.ndarray | None = None,
                 device=None):
        self.device = _device.resolve(device)
        self.num_items = num_items
        self.dim = dim
        if item_vecs is None:
            g = _device.generator(seed, self.device)
            v = sift_like(g, num_items, dim, num_clusters=num_clusters,
                          anisotropy=4.0, device=self.device)
            item_vecs = v.cpu().numpy()
            item_vecs /= np.linalg.norm(item_vecs, axis=1,
                                        keepdims=True) + 1e-9
        self.item_vecs = np.array(item_vecs, dtype=np.float32)
        if self.item_vecs.shape != (num_items, dim):
            raise ValueError(f"item_vecs {self.item_vecs.shape} != "
                             f"({num_items}, {dim})")
        pop = 1.0 / np.arange(1, num_items + 1) ** 1.05
        self._pop = pop / pop.sum()

    def _batch_np(self, seed: int, batch: int, hist_len: int, cand: int):
        rng = np.random.RandomState(seed)
        # a "session anchor" item by popularity; history = its knn-ish
        anchors = rng.choice(self.num_items, size=batch, p=self._pop)
        av = self.item_vecs[anchors]                                # (B, d)
        # propose candidates, keep the most similar as history + label
        props = rng.randint(0, self.num_items, size=(batch, cand))
        sims = np.einsum("bd,bcd->bc", av, self.item_vecs[props])
        order = np.argsort(-sims, axis=1)
        top = np.take_along_axis(props, order, axis=1)
        hist = top[:, 1:hist_len + 1].astype(np.int32)
        if hist.shape[1] < hist_len:
            pad = -np.ones((batch, hist_len - hist.shape[1]), np.int32)
            hist = np.concatenate([hist, pad], axis=1)
        # random-length histories (pad tail with −1)
        lens = rng.randint(max(1, hist_len // 4), hist_len + 1, size=batch)
        mask = np.arange(hist_len)[None, :] < lens[:, None]
        hist = np.where(mask, hist, -1).astype(np.int32)
        pos = top[:, 0].astype(np.int32)
        return hist, pos

    def batch(self, seed: int, batch: int, hist_len: int, cand: int = 64):
        """(hist_ids (B, L) int32 with −1 padding, pos_ids (B,) int32) on
        the log's device."""
        hist, pos = self._batch_np(seed, batch, hist_len, cand)
        return (torch.from_numpy(hist).to(self.device),
                torch.from_numpy(pos).to(self.device))

    def eval_queries(self, seed: int, num: int, hist_len: int,
                     k_truth: int = 100):
        """Queries and their ground-truth top-k items by latent similarity
        (the paper's Table 1 protocol): (hist (num, L) int32,
        truth (num, k_truth) int64), both on the log's device. The
        similarities of all items are taken there in float64 with
        ``torch.topk``, where the JAX package argsorts them in numpy."""
        hist, _ = self._batch_np(seed, num, hist_len, 64)
        hv = np.zeros((num, self.dim))
        for b in range(num):
            ids = hist[b][hist[b] >= 0]
            hv[b] = self.item_vecs[ids].mean(0) if len(ids) else 0.0
        vecs = torch.from_numpy(self.item_vecs).to(self.device, torch.float64)
        sims = torch.from_numpy(hv).to(self.device) @ vecs.T     # (num, N)
        truth = torch.topk(sims, k_truth, dim=1).indices
        return torch.from_numpy(hist).to(self.device), truth
