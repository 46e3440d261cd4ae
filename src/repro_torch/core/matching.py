"""Coordinate-pair selection for Givens coordinate descent (port of
``repro/core/matching.py``: GCD-G).

The matching is a serial scan over sorted edges, so it runs on the host in
numpy whatever the device of ``A``: at the slice's n = 256 the (n, n)
score field is 256 KiB, and a scan of a few thousand edges costs well
under a millisecond on the host, where a device loop would pay one
synchronisation per edge. Ties in |A| go to the lower flat edge index, as
``jax.lax.top_k`` orders them in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def _weights(A: torch.Tensor) -> np.ndarray:
    return np.abs(A.detach().to("cpu", torch.float32).numpy())


def _as_pairs(pi: list[int], pj: list[int], device: torch.device):
    return (torch.tensor(pi, dtype=torch.int64, device=device),
            torch.tensor(pj, dtype=torch.int64, device=device))


def _scan(order: np.ndarray, n: int, used: np.ndarray, pi: list[int],
          pj: list[int], p: int) -> None:
    """Greedy pass over edge indices (flat i·n + j) in the given order."""
    for e in order.tolist():
        i, j = divmod(e, n)
        if i != j and not used[i] and not used[j]:
            used[i] = used[j] = True
            pi.append(i)
            pj.append(j)
            if len(pi) == p:
                return


def greedy_matching(A: torch.Tensor):
    """GCD-G (Algorithm 1): sort every i<j edge by |A_ij| descending and take
    an edge whenever both endpoints are free. The test oracle of
    ``greedy_matching_fast``."""
    n = A.shape[0]
    p = n // 2
    w = _weights(A)
    flat = np.where(np.triu(np.ones((n, n), bool), 1), w, -np.inf).ravel()
    order = np.argsort(-flat, kind="stable")
    used = np.zeros(n, bool)
    pi: list[int] = []
    pj: list[int] = []
    _scan(order, n, used, pi, pj, p)
    return _as_pairs(pi, pj, A.device)


def greedy_matching_fast(A: torch.Tensor):
    """The same matching as ``greedy_matching``, in rounds: mask the used
    nodes out of |A|, sort, scan only the top ``8n`` edges. Restricting
    greedy to the free nodes and re-sorting yields exactly the same
    matching, and every round matches at least one pair."""
    n = A.shape[0]
    p = n // 2
    m = min(8 * n, n * n)
    w0 = _weights(A)
    upper = np.triu(np.ones((n, n), bool), 1)
    used = np.zeros(n, bool)
    pi: list[int] = []
    pj: list[int] = []
    while len(pi) < p:
        free = ~used
        mask = upper & free[:, None] & free[None, :]
        flat = np.where(mask, w0, -np.inf).ravel()
        order = np.argsort(-flat, kind="stable")[:m]
        _scan(order, n, used, pi, pj, p)
    return _as_pairs(pi, pj, A.device)


def matching_weight(A: torch.Tensor, pi: torch.Tensor,
                    pj: torch.Tensor) -> torch.Tensor:
    """Total |A| weight of a matching."""
    return torch.sum(torch.abs(A[pi.long(), pj.long()]))
