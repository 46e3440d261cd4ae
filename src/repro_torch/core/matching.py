"""Coordinate-pair selection for Givens coordinate descent (port of
``repro/core/matching.py``): a perfect matching of the n coordinate axes,
by one of the paper's three strategies.

  * GCD-R  ``random_matching``    a ``torch.randperm`` drawn from an
           explicit generator, its halves paired;
  * GCD-G  ``greedy_matching_fast``  sort |A|, greedy disjoint scan;
  * GCD-S  ``steepest_matching``  GCD-G's matching refined by
           ``two_opt_refine``, the JAX package's vectorised 2-opt.

Also the paper's overlapping ablations (§3.1): ``overlapping_topk`` and
``overlapping_random`` pick n/2 edges without the disjointness constraint,
and ``exact_matching_dp`` is the exact bitmask-DP test oracle for small n.

The greedy scan is serial over sorted edges, so it runs on the host in
numpy whatever the device of ``A``: a device loop would pay one
synchronisation per edge. It is not cheap: at n = 512 each round sorts all
262,144 entries of |A| on the host (about 15 ms on a CPU for a random
field), and with an NVIDIA H100 the copy and the rounds take 43–55 ms of
a 119–132 ms GCD-G joint step of the paper's two-tower model
(``chip_smoke.py`` train). Ties in |A| go to the lower flat edge index,
as ``jax.lax.top_k`` orders them in the JAX package.

``two_opt_refine`` runs on A's device and its sweeps never wait for the
host, as the JAX ``fori_loop`` does not. Its
16 sweeps of about 30 small launches each are bound by the host's launch
rate: on an NVIDIA H100 they take 5.5 ms at n = 512, against 38.5 ms for
the greedy matching they refine (``chip_smoke.py`` train_kernels, one
CUDA-event pair around each call).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


def random_matching(generator: torch.Generator, n: int, device=None):
    """GCD-R: a uniformly random perfect matching of {0..n-1} from
    ``generator`` (on ``device``, the card by default)."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    perm = torch.randperm(n, generator=generator, device=dev)
    p = n // 2
    return perm[:p], perm[p:2 * p]


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
    matching, pair for pair in the same order, and every round matches at
    least one pair."""
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


def two_opt_refine(A: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                   sweeps: int = 16):
    """Vectorised 2-opt (``repro/core/matching.py:135-169``): each sweep
    takes the single best pair swap over all pairs of pairs. For pairs
    (i₁, j₁), (i₂, j₂) the rewirings are (i₁, i₂), (j₁, j₂) and
    (i₁, j₂), (j₁, i₂); a swap is applied only if it gains more than
    1e-12, so the total |A| weight never falls below the start's.

    The gains are the JAX package's float32 sums in the same order, the
    argmax takes the first flat index of a tie, and the rewiring is
    applied by ``torch.where`` on the device: no sweep reads a value back
    to the host."""
    w = torch.abs(A.float())
    pi, pj = pi.long(), pj.long()
    p = pi.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=w.device)
    for _ in range(sweeps):
        cur = w[pi, pj]
        pair_w = cur[:, None] + cur[None, :]
        alt1 = w[pi[:, None], pi[None, :]] + w[pj[:, None], pj[None, :]]
        alt2 = w[pi[:, None], pj[None, :]] + w[pj[:, None], pi[None, :]]
        gain = torch.maximum(alt1, alt2) - pair_w
        gain = gain.masked_fill(eye, -torch.inf)
        idx = torch.argmax(gain.reshape(-1)).reshape(1)
        a, b = idx // p, idx % p
        use1 = alt1[a, b] >= alt2[a, b]
        improving = gain[a, b] > 1e-12
        # new pair a: (pi[a], pi[b] or pj[b]); new pair b: (pj[a], pj[b]
        # or pi[b])
        pia, pja, pib, pjb = pi[a], pj[a], pi[b], pj[b]
        na_j = torch.where(use1, pib, pjb)
        nb_j = torch.where(use1, pjb, pib)
        new_pi = pi.scatter(0, b, pja)
        new_pj = pj.scatter(0, a, na_j).scatter(0, b, nb_j)
        pi = torch.where(improving, new_pi, pi)
        pj = torch.where(improving, new_pj, pj)
    return pi, pj


def steepest_matching(A: torch.Tensor, sweeps: int = 16):
    """GCD-S: the greedy matching refined by ``sweeps`` 2-opt sweeps. It
    starts from ``greedy_matching_fast``, which gives the JAX package's
    ``greedy_matching`` pair for pair, so it does not pay that function's
    one-edge-at-a-time scan."""
    pi, pj = greedy_matching_fast(A)
    return two_opt_refine(A, pi, pj, sweeps=sweeps)


def overlapping_topk(A: torch.Tensor, k: int | None = None):
    """The §3.1 ablation: the top-k |A| edges i < j WITHOUT disjointness
    (k = n // 2 by default), by descending |A|. The pairs may share axes
    and do not commute: ``rotations.base.GivensDelta(overlapping=True)``
    applies them one after another. A stable descending sort of the
    masked field gives ``jax.lax.top_k``'s order, ties to the lower flat
    index, and runs on A's device."""
    n = A.shape[0]
    k = n // 2 if k is None else k
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=A.device), 1)
    flat = torch.where(upper, torch.abs(A),
                       torch.full_like(A, -torch.inf)).reshape(-1)
    idx = torch.argsort(flat, descending=True, stable=True)[:k]
    return idx // n, idx % n


def overlapping_random(generator: torch.Generator, n: int,
                       k: int | None = None, device=None):
    """The overlapping GCD-R ablation: k random edges (k = n // 2 by
    default) that may share axes, from ``generator`` on ``device`` (the
    card by default). j is i plus an offset drawn from [1, n), mod n, so
    j ≠ i, as the JAX package draws them; each pair is (min, max)."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    k = n // 2 if k is None else k
    i = torch.randint(0, n, (k,), generator=generator, device=dev)
    off = torch.randint(1, n, (k,), generator=generator, device=dev)
    j = (i + off) % n
    return torch.minimum(i, j), torch.maximum(i, j)


def exact_matching_dp(A):
    """Exact max-weight perfect matching by bitmask DP (the test oracle,
    even n ≤ 16): dp[mask] is the best total |A| weight perfectly matching
    the set bits of mask, O(2ⁿ·n²) in numpy and Python. Returns (pi, pj)
    as int32 numpy arrays, in the order the backtrack meets them reversed,
    and the weight."""
    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().numpy()
    w = np.abs(np.asarray(A))
    n = w.shape[0]
    assert n % 2 == 0 and n <= 16, "oracle is for small even n"
    full = (1 << n) - 1
    NEG = -np.inf
    dp = np.full(1 << n, NEG)
    choice = np.full((1 << n, 2), -1, dtype=np.int64)
    dp[0] = 0.0
    for mask in range(1 << n):
        if dp[mask] == NEG:
            continue
        i = 0                                   # the first free axis
        while i < n and (mask >> i) & 1:
            i += 1
        if i == n:
            continue
        for j in range(i + 1, n):
            if (mask >> j) & 1:
                continue
            nm = mask | (1 << i) | (1 << j)
            val = dp[mask] + w[i, j]
            if val > dp[nm]:
                dp[nm] = val
                choice[nm] = (i, j)
    pairs = []
    mask = full
    while mask:
        i, j = choice[mask]
        pairs.append((int(i), int(j)))
        mask &= ~((1 << int(i)) | (1 << int(j)))
    pairs = pairs[::-1]
    pi = np.array([a for a, _ in pairs], dtype=np.int32)
    pj = np.array([b for _, b in pairs], dtype=np.int32)
    return pi, pj, float(dp[full])


def matching_weight(A: torch.Tensor, pi: torch.Tensor,
                    pj: torch.Tensor) -> torch.Tensor:
    """Total |A| weight of a matching."""
    return torch.sum(torch.abs(A[pi.long(), pj.long()]))
