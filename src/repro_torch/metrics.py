"""Retrieval quality metrics (port of ``repro/metrics.py``)."""
from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def recall_at_k(pred_ids, true_ids, k: int | None = None) -> float:
    """Mean fraction of each row's true top-k found in the predicted top-k.
    ``pred_ids`` may hold −1 padding, which never counts as a hit; rows of
    ``true_ids`` are distinct within a row."""
    pred_ids = _host(pred_ids)
    true_ids = _host(true_ids)
    k = k if k is not None else true_ids.shape[1]
    pred = pred_ids[:, :k]
    true = true_ids[:, :k]
    hit = (true[:, :, None] == pred[:, None, :]) & (pred[:, None, :] >= 0)
    return float(hit.any(axis=2).sum(axis=1).mean() / k)
