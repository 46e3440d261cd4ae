"""Plain PyTorch versions of the kernels this port carries (port of
``repro/kernels/ref.py``).

Each ``<name>_ref`` is the semantic ground truth of its kernel. The wrappers
in ``kernels/ops.py`` call them for CPU tensors; ``chip_smoke.py`` holds each
CUDA kernel against them on the card. The scan references sum the Dp
columns in ascending order, one column at a time, which is also the order
the CUDA scan body sums them in; a column-at-a-time gather keeps the peak
temporary at one (rows,) slab instead of a (rows, Dp) gather.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.adc_common import dequantize_luts


def pair_rotate_ref(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                    c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The givens_rotate kernel's function over a full (m, n) X: columns
    pi[l] and pj[l] mixed by cos/sin (p,) as y_i = c·x_i + s·x_j and
    y_j = c·x_j − s·x_i, every other column copied. Pairs are disjoint. Each
    product and sum is one rounded elementwise op, as in the kernel."""
    pi = pi.long()
    pj = pj.long()
    c = c.to(X.dtype)
    s = s.to(X.dtype)
    xi = X[..., pi]
    xj = X[..., pj]
    Y = X.clone()
    Y[..., pi] = c * xi + s * xj
    Y[..., pj] = c * xj - s * xi
    return Y


def apply_pair_rotations_ref(X: torch.Tensor, pi: torch.Tensor,
                             pj: torch.Tensor,
                             theta: torch.Tensor) -> torch.Tensor:
    """X (..., n) right-multiplied by ∏ℓ R_{pi[ℓ],pj[ℓ]}(θℓ) over disjoint
    pairs; differentiable by torch.autograd in X and θ."""
    return pair_rotate_ref(X, pi, pj, torch.cos(theta), torch.sin(theta))


def pq_assign_ref(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: X (m, n), codebooks (D, K, sub) ->
    (m, D) int32, the argmin over k of ‖C[d,k]‖² − 2⟨x_d, C[d,k]⟩, ties to
    the first k."""
    D = codebooks.shape[0]
    m, n = X.shape
    dots = torch.einsum("mds,dks->mdk", X.reshape(m, D, n // D), codebooks)
    cn = torch.sum(torch.square(codebooks), dim=-1)
    return torch.argmin(cn[None] - 2.0 * dots, dim=-1).to(torch.int32)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      bag_ids: torch.Tensor, num_bags: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag(sum): table (V, dim), flat indices (L,), sorted bag_ids
    (L,), optional weights (L,) -> (num_bags, dim) float32.

    The semantics are those of the JAX package's kernel wrapper
    (``repro/kernels/embedding_bag.py``): an index < 0 is padding and adds
    nothing, a bag with no entries is 0. (The JAX ``embedding_bag_ref``
    itself does not mask −1; its callers mask first.) Entries are added in
    index order."""
    valid = indices >= 0
    rows = table[torch.clamp(indices, min=0).long()].float()
    if weights is not None:
        rows = rows * weights.float()[:, None]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
    out = torch.zeros((num_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    return out.index_add_(0, bag_ids.long(), rows)


def gcd_score_ref(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A = M − Mᵀ with M = GᵀR (paper Algorithm 2 line 3)."""
    M = G.T.float() @ R.float()
    return (M - M.T).to(R.dtype)


def fused_lut_ref(Q: torch.Tensor, qdelta: torch.Tensor,
                  cb_flat: torch.Tensor, colmap: torch.Tensor) -> torch.Tensor:
    """Rotation-fused ADC table build. Q (b, n) queries, qdelta (n, n) the
    query-side transform of fused refresh, cb_flat (Dp, K, sub) frozen
    codebooks flattened by code column, colmap (Dp, D) one-hot code column
    -> query subspace map (identity for PQ; column l·D+d of a level-major
    depth-M RQ maps to subspace d) -> (b, Dp, K) float32 with
    lut[b, p, k] = ⟨(Q·qdelta) subspace of column p, cb_flat[p, k]⟩."""
    QL = Q.float() @ qdelta.float()                                # (b, n)
    b, n = QL.shape
    D = colmap.shape[1]
    QLs = QL.reshape(b, D, n // D)
    Qexp = torch.einsum("pd,bds->bps", colmap.float(), QLs)
    return torch.einsum("bps,pks->bpk", Qexp, cb_flat.float())


def _lut_f32(lut: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    if scales is not None:
        return dequantize_luts(lut, scales)
    return lut.float()


def adc_lookup_ref(lut: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor | None = None,
                   ids: torch.Tensor | None = None) -> torch.Tensor:
    """ADC score sum. lut (b, D, K), codes (N, D) -> (b, N) float32 with
    out[q, n] = Σ_d LUT[q, d, codes[n, d]].

    ``scales`` (b, D, 2): the lut is an int8/uint8 quantize_luts pack and is
    dequantized first. ``ids`` (N,): rows with id < 0 score −inf."""
    lut = _lut_f32(lut, scales)
    b, D, _ = lut.shape
    out = torch.zeros((b, codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for d in range(D):
        out += lut[:, d, :].index_select(1, codes[:, d].long())
    if ids is not None:
        out.masked_fill_(ids[None, :] < 0, float("-inf"))
    return out


def adc_batch_ref(lut: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped ADC score sum (KV-cache scoring). lut (g, r, Dp, K),
    codes (g, S, Dp) -> (g, r, S) float32 with
    out[g, r, s] = Σ_d lut[g, r, d, codes[g, s, d]].

    One code column at a time in ascending order, so the peak temporary is
    one (g, r, S) slab. ``scales`` (g, r, Dp, 2): the lut is an int8/uint8
    quantize_luts pack and is dequantized first."""
    lut = _lut_f32(lut, scales)
    g, r, Dp, _ = lut.shape
    S = codes.shape[1]
    out = torch.zeros((g, r, S), dtype=torch.float32, device=lut.device)
    for d in range(Dp):
        idx = codes[:, :, d].long()[:, None, :].expand(g, r, S)
        out += torch.gather(lut[:, :, d, :], 2, idx)
    return out


def ivf_adc_ref(lut: torch.Tensor, codes: torch.Tensor,
                block_idx: torch.Tensor, block_query: torch.Tensor, *,
                block_size: int = 128, scales: torch.Tensor | None = None,
                ids: torch.Tensor | None = None) -> torch.Tensor:
    """Selected-block ADC scan. lut (b, D, K), codes (cap, D),
    block_idx/block_query (S,) -> (S, block_size): the scores of tile
    ``block_idx[s]`` of the CSR codes array under query ``block_query[s]``'s
    LUT. ``scales``: quantized-LUT pack. ``ids`` (cap,): rows with id < 0
    score −inf."""
    lut = _lut_f32(lut, scales)
    D = lut.shape[1]
    rows = (block_idx.long()[:, None] * block_size
            + torch.arange(block_size, device=codes.device))      # (S, bs)
    q = block_query.long()[:, None]                               # (S, 1)
    out = torch.zeros(rows.shape, dtype=torch.float32, device=lut.device)
    for d in range(D):
        out += lut[:, d, :][q, codes[:, d][rows].long()]
    if ids is not None:
        out.masked_fill_(ids[rows] < 0, float("-inf"))
    return out


def topk_merge_ref(scores: torch.Tensor, ids: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (b, C) candidates under the padding contract.

    Equal scores rank by ascending id (a stable sort by id, then a stable
    sort by −score, equal to the JAX package's two-key sort), so the result
    is a function of the candidate set alone. Slots whose score is −inf get
    id −1; when k > C the output is padded with (−inf, −1). Returns (b, k)
    float32 scores and int32 ids."""
    b, C = scores.shape
    kk = min(k, C)
    ids = ids.to(torch.int32)
    by_id = torch.argsort(ids, dim=1, stable=True)
    s1 = scores.gather(1, by_id)
    i1 = ids.gather(1, by_id)
    by_score = torch.argsort(-s1, dim=1, stable=True)[:, :kk]
    top_scores = s1.gather(1, by_score)
    top_ids = i1.gather(1, by_score)
    top_ids = torch.where(torch.isfinite(top_scores), top_ids,
                          torch.full_like(top_ids, -1))
    if kk < k:
        pad = k - kk
        top_scores = torch.cat([top_scores, torch.full(
            (b, pad), float("-inf"), dtype=top_scores.dtype,
            device=scores.device)], dim=1)
        top_ids = torch.cat([top_ids, torch.full(
            (b, pad), -1, dtype=torch.int32, device=scores.device)], dim=1)
    return top_scores, top_ids
