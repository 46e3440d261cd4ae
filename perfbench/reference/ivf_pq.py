"""Plain IVF-PQ in PyTorch: the k-means that makes the benchmark's
quantizers, the encode, and the search whose answers the served ones are
held to.

Semantics (those of an IVF-PQ index over a learned rotation R):

* a row x lands in the list of its nearest centroid c (argmin of
  ‖c‖² − 2⟨xR, c⟩, ties to the lower list) and stores, per subspace d, the
  nearest codeword of the residual xR − c (same rule, ties to the lower
  codeword);
* a query q is rotated, its ``nprobe`` lists are those of the largest
  ⟨qR, c⟩ (ties to the lower list), and every row of those lists scores
  ⟨qR, c_list⟩ + Σ_d ⟨(qR)_d, C[d, code_d]⟩;
* the answer is the ``k`` best scores, ties to the smaller id.

Every product goes through ``precision.matmul``, so the same code is the
float32 reference and, in TF32, the control. Sums of members in the
k-means are one-hot products, whose order cuBLAS fixes by shape, so the
same seed gives the same quantizers on every run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.precision import matmul

#: rows a product or an argmin works on at a time
ROWS = 65536


def nearest(X: torch.Tensor, C: torch.Tensor, mm=torch.matmul,
            rows: int = ROWS) -> torch.Tensor:
    """(m, n) rows, (k, n) centers -> (m,) int64 nearest center."""
    cn = (C * C).sum(-1)
    out = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    for s in range(0, X.shape[0], rows):
        out[s:s + rows] = torch.argmin(cn - 2.0 * mm(X[s:s + rows], C.T),
                                       dim=1)
    return out


def pq_codes(X: torch.Tensor, codebooks: torch.Tensor, mm=torch.matmul,
             rows: int = ROWS) -> torch.Tensor:
    """(m, D·sub) rows, (D, K, sub) codebooks -> (m, D) int64 codes."""
    D, K, sub = codebooks.shape
    cn = (codebooks * codebooks).sum(-1)                       # (D, K)
    ct = codebooks.transpose(1, 2)                             # (D, sub, K)
    out = torch.empty((X.shape[0], D), dtype=torch.int64, device=X.device)
    for s in range(0, X.shape[0], rows):
        xs = X[s:s + rows].reshape(-1, D, sub).transpose(0, 1)  # (D, m, sub)
        dots = mm(xs, ct)                                       # (D, m, K)
        out[s:s + rows] = torch.argmin(cn[:, None] - 2.0 * dots, dim=2).T
    return out


def _member_sums(X: torch.Tensor, assign: torch.Tensor, k: int):
    """(k, n) sums of the rows of each center and (k,) counts; a one-hot
    product in float32, so its order is fixed."""
    onehot = torch.zeros((k, X.shape[0]), dtype=X.dtype, device=X.device)
    onehot[assign, torch.arange(X.shape[0], device=X.device)] = 1.0
    return onehot @ X, torch.bincount(assign, minlength=k)


def kmeans(generator: torch.Generator, X: torch.Tensor, k: int,
           iters: int) -> torch.Tensor:
    """Lloyd's k-means from k distinct rows; an empty center stays put."""
    C = X[torch.randperm(X.shape[0], generator=generator,
                         device=X.device)[:k]].clone()
    for _ in range(iters):
        sums, counts = _member_sums(X, nearest(X, C), k)
        keep = counts == 0
        C = torch.where(keep[:, None], C,
                        sums / counts.clamp(min=1)[:, None].to(X.dtype))
    return C


def fit_pq(generator: torch.Generator, X: torch.Tensor, D: int, K: int,
           iters: int) -> torch.Tensor:
    """(D, K, sub) codebooks: k-means in each of the D subspaces."""
    sub = X.shape[1] // D
    return torch.stack([kmeans(generator, X[:, d * sub:(d + 1) * sub], K,
                               iters) for d in range(D)])


class Index(NamedTuple):
    """A plain IVF-PQ index: rows grouped by list."""

    lists: torch.Tensor     # (N,) int64 list of each row
    codes: torch.Tensor     # (N, D) int64
    order: torch.Tensor     # (N,) int64 row ids, by list, stable
    offsets: torch.Tensor   # (L + 1,) int64 start of each list in order


def build(X: torch.Tensor, R: torch.Tensor, centroids: torch.Tensor,
          codebooks: torch.Tensor, precision: str = "float32",
          rows: int = ROWS) -> Index:
    """Encode every row of X (N, n) against the given quantizers."""
    mm = matmul(precision)
    N = X.shape[0]
    lists = torch.empty(N, dtype=torch.int64, device=X.device)
    codes = torch.empty((N, codebooks.shape[0]), dtype=torch.int64,
                        device=X.device)
    for s in range(0, N, rows):
        xr = mm(X[s:s + rows], R)
        li = nearest(xr, centroids, mm)
        lists[s:s + rows] = li
        codes[s:s + rows] = pq_codes(xr - centroids[li], codebooks, mm)
    order = torch.sort(lists, stable=True).indices
    counts = torch.bincount(lists, minlength=centroids.shape[0])
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=X.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return Index(lists, codes, order, offsets)


def probe(Q: torch.Tensor, R: torch.Tensor, centroids: torch.Tensor,
          nprobe: int, precision: str = "float32"):
    """(QR (b, n), coarse scores (b, L), probed lists (b, nprobe))."""
    mm = matmul(precision)
    QR = mm(Q, R)
    coarse = mm(QR, centroids.T)
    lists = torch.sort(coarse, dim=1, descending=True, stable=True).indices
    return QR, coarse, lists[:, :nprobe]


def search(index: Index, Q: torch.Tensor, R: torch.Tensor,
           centroids: torch.Tensor, codebooks: torch.Tensor, nprobe: int,
           k: int, precision: str = "float32"):
    """Top-k (scores (b, k) float32, ids (b, k) int64) of each query."""
    mm = matmul(precision)
    D, K, sub = codebooks.shape
    QR, coarse, probed = probe(Q, R, centroids, nprobe, precision)
    luts = mm(QR.reshape(-1, D, 1, sub), codebooks.transpose(1, 2))
    luts = luts.reshape(-1, D * K)                             # (b, D·K)
    col = torch.arange(D, device=Q.device) * K
    starts, ends = index.offsets[:-1].tolist(), index.offsets[1:].tolist()
    scores, ids = [], []
    for b, ls in enumerate(probed.tolist()):
        rows = torch.cat([index.order[starts[li]:ends[li]] for li in ls])
        s = luts[b][index.codes[rows] + col].sum(1) + coarse[b][
            index.lists[rows]]
        by_id = torch.sort(rows).indices           # ties to the smaller id
        rows, s = rows[by_id], s[by_id]
        top = torch.sort(s, descending=True, stable=True).indices[:k]
        scores.append(s[top])
        ids.append(rows[top])
    return torch.stack(scores), torch.stack(ids)


def list_sizes(index: Index) -> torch.Tensor:
    """(L,) rows in each list."""
    return index.offsets[1:] - index.offsets[:-1]
