"""Latent-factor click log: a frozen copy of
``repro_torch.data.synthetic.ClickLog``.

Items live in a latent space; a user's history is the items nearest a
popularity-drawn (Zipf 1.05) anchor among ``cand`` random proposals, the
positive item the nearest of all. Histories have random lengths, padded
with −1.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.traffic.sift_like import sift_like


class ClickLog:
    """``item_vecs`` (num_items, dim) unit-norm latent vectors, drawn on the
    generator's device and kept on the host for the numpy batch draws."""

    def __init__(self, generator: torch.Generator, num_items: int,
                 dim: int = 32, num_clusters: int = 64):
        self.num_items = num_items
        v = sift_like(generator, num_items, dim, num_clusters=num_clusters,
                      anisotropy=4.0)
        v = v.cpu().numpy()
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        self.item_vecs = v.astype(np.float32)
        pop = 1.0 / np.arange(1, num_items + 1) ** 1.05
        self._cdf = np.cumsum(pop / pop.sum())

    def batch(self, seed: int, batch: int, hist_len: int, cand: int = 64):
        """(hist (B, hist_len) int32, −1 padded; pos (B,) int32), numpy."""
        rng = np.random.RandomState(seed)
        anchors = np.minimum(np.searchsorted(self._cdf, rng.random_sample(
            batch), side="right"), self.num_items - 1)
        av = self.item_vecs[anchors]
        props = rng.randint(0, self.num_items, size=(batch, cand))
        sims = np.einsum("bd,bcd->bc", av, self.item_vecs[props])
        top = np.take_along_axis(props, np.argsort(-sims, axis=1), axis=1)
        hist = top[:, 1:hist_len + 1].astype(np.int32)
        lens = rng.randint(max(1, hist_len // 4), hist_len + 1, size=batch)
        mask = np.arange(hist_len)[None, :] < lens[:, None]
        hist = np.where(mask, hist, -1).astype(np.int32)
        return hist, top[:, 0].astype(np.int32)
