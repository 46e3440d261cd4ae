"""Lloyd's k-means for codebooks and coarse centroids, its row-sharded
flavour, and the streaming EMA codebook update (port of
``repro/quant/kmeans.py``).

One implementation serves per-subspace PQ codebooks and, through
``vq_kmeans`` (one subspace), the IVF coarse centroids. Random state is an
explicit ``torch.Generator`` on the data's device.

The per-codeword sums go through ``segment_sum``, which gives one answer
a seed on the card too, as the JAX package's ``segment_sum`` does: there
``index_add_`` adds in no fixed order, so two builds of one seed would
differ.

``kmeans_sharded`` splits the rows over a ``launch.mesh.DataMesh``: each
shard assigns its own rows (``pq_assign`` on its device) and sums them
per codeword, and the partial sums and counts are added in shard order on
the first shard's device, the JAX package's ``psum``. The update is
``kmeans``'s with the sums in another order, so the fit is close to the
single-device one, not equal to it; each shard's sums are
``segment_sum``'s, so one seed gives one sharded fit.
"""
from __future__ import annotations

import torch

from repro_torch.quant.base import PQConfig
from repro_torch.quant.codebook import assign, distortion, split


def kmeans_init(generator: torch.Generator, X: torch.Tensor,
                cfg: PQConfig) -> torch.Tensor:
    """Codebooks from K distinct sampled rows per subspace: (D, K, sub)."""
    m = X.shape[0]
    if cfg.num_codewords > m:
        raise ValueError(f"k-means needs at least K={cfg.num_codewords} "
                         f"rows, got {m}")
    idx = torch.randperm(m, generator=generator,
                         device=X.device)[:cfg.num_codewords]
    return split(X[idx], cfg.num_subspaces).transpose(0, 1).contiguous()


def segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Σ of the rows (M, w) of each segment -> (num_segments, w), the same
    bits in every run on either device: a stable sort of the rows by
    segment, then each segment's rows summed one after another in row
    order from 0, the order ``index_add_`` takes on the CPU, where the two
    agree bit for bit. On the card ``index_add_`` adds in no fixed order;
    here the sort is a radix sort and each output element one thread's
    loop. No process-wide deterministic mode is switched on: a compactor
    thread runs beside the serving thread. A segment no row chose sums
    to 0."""
    order = torch.sort(seg, stable=True)[1]
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(rows[order], "sum", lengths=lengths,
                                unsafe=True)


def _counts(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment as float32. Sums of 1.0 are exact in any order
    below 2²⁴ rows a segment, so ``index_add_`` gives one answer here on
    either device."""
    cnt = torch.zeros((num_segments,), dtype=torch.float32, device=seg.device)
    return cnt.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))


def kmeans_update(X: torch.Tensor, codebooks: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over all D subspaces -> (codebooks, codes).
    Empty clusters keep their previous centroid."""
    D, K, sub = codebooks.shape
    codes = assign(X, codebooks)                                   # (m, D)
    seg = (codes.long()
           + torch.arange(D, device=X.device) * K).reshape(-1)     # (m·D,)
    rows = split(X, D).reshape(-1, sub)                            # (m·D, sub)
    sums = segment_sum(rows, seg, D * K).view(D, K, sub)
    cnt = _counts(seg, D * K).view(D, K, 1)
    new = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), codebooks)
    return new, codes


def kmeans(generator: torch.Generator, X: torch.Tensor, cfg: PQConfig,
           iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """k-means per subspace -> (codebooks, distortion trace (iters,))."""
    cb = kmeans_init(generator, X, cfg)
    trace = []
    for _ in range(iters):
        cb, codes = kmeans_update(X, cb)
        trace.append(distortion(X, cb, codes))
    return cb, torch.stack(trace) if trace else torch.zeros((0,))


def vq_kmeans(generator: torch.Generator, X: torch.Tensor, num_centroids: int,
              iters: int = 10) -> torch.Tensor:
    """Full-vector k-means: (L, n) centroids, the IVF coarse fit."""
    cb, _ = kmeans(generator, X, PQConfig(1, num_centroids), iters=iters)
    return cb[0]


def _sharded_lloyd_step(codebooks: torch.Tensor, Xs: torch.Tensor,
                        w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's part of a Lloyd iteration: the weighted per-codeword
    sums (D, K, sub) and counts (D, K) of its rows ``Xs``, on their device.
    ``w`` is 1 for a real row and 0 for the padding that makes the row
    count a multiple of the shard count, so padding adds nothing."""
    D, K, sub = codebooks.shape
    codes = assign(Xs, codebooks)                                  # (m, D)
    seg = (codes.long()
           + torch.arange(D, device=Xs.device) * K).reshape(-1)    # (m·D,)
    rows = (split(Xs, D) * w[:, None, None]).reshape(-1, sub)
    sums = segment_sum(rows, seg, D * K).view(D, K, sub)
    cnt = torch.zeros((D * K,), dtype=torch.float32, device=Xs.device)
    cnt.index_add_(0, seg, w.repeat_interleave(D))
    return sums, cnt.view(D, K)


def kmeans_sharded(generator: torch.Generator, X: torch.Tensor,
                   cfg: PQConfig, *, mesh, axis: str = "data",
                   iters: int = 10) -> torch.Tensor:
    """``kmeans`` with the rows of ``X`` split over ``mesh``'s ``axis``
    (module docstring). The init samples K rows as ``kmeans`` does, from
    the same generator; zero-weight rows pad X to a multiple of the shard
    count. Returns (D, K, sub) codebooks on the first shard's device."""
    devices = mesh.devices
    S = mesh.shape[axis]
    if S != len(devices):
        raise ValueError(f"axis {axis!r} has {S} shards, the mesh "
                         f"{len(devices)} devices")
    head = devices[0]
    X = X.to(head)
    m = X.shape[0]
    pad = (-m) % S
    cb = kmeans_init(generator, X, cfg)
    Xp = torch.cat([X, X.new_zeros((pad, X.shape[1]))]) if pad else X
    w = torch.cat([torch.ones((m,), device=head),
                   torch.zeros((pad,), device=head)])
    ms = Xp.shape[0] // S
    parts = [(Xp[s * ms:(s + 1) * ms].to(d), w[s * ms:(s + 1) * ms].to(d))
             for s, d in enumerate(devices)]
    for _ in range(iters):
        sums = cnt = None
        for (xs, ws), d in zip(parts, devices):
            s_sum, s_cnt = _sharded_lloyd_step(cb.to(d), xs, ws)
            s_sum, s_cnt = s_sum.to(head), s_cnt.to(head)
            sums = s_sum if sums is None else sums + s_sum
            cnt = s_cnt if cnt is None else cnt + s_cnt
        cnt = cnt[..., None]
        cb = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), cb)
    return cb


def vq_kmeans_sharded(generator: torch.Generator, X: torch.Tensor,
                      num_centroids: int, *, mesh, axis: str = "data",
                      iters: int = 10) -> torch.Tensor:
    """``vq_kmeans`` with the fit sharded over ``mesh``'s ``axis``: the
    coarse fit of ``index.ivf.build_sharded``."""
    cb = kmeans_sharded(generator, X, PQConfig(1, num_centroids), mesh=mesh,
                        axis=axis, iters=iters)
    return cb[0]


def codebook_ema_update(codebooks: torch.Tensor, X: torch.Tensor,
                        codes: torch.Tensor, decay: float = 0.99
                        ) -> torch.Tensor:
    """Streaming EMA codebook update (VQ-VAE style): each codeword moves
    towards the mean of the rows assigned to it, ``decay·C + (1 − decay)·
    mean``; a codeword no row chose keeps its value. The per-codeword sums
    go through ``segment_sum``: one answer a seed on either device."""
    D, K, sub = codebooks.shape
    seg = (codes.long()
           + torch.arange(D, device=X.device) * K).reshape(-1)     # (m·D,)
    rows = split(X, D).reshape(-1, sub)
    sums = segment_sum(rows, seg, D * K).view(D, K, sub)
    cnt = _counts(seg, D * K).view(D, K, 1)
    batch_mean = sums / torch.clamp(cnt, min=1.0)
    upd = decay * codebooks + (1.0 - decay) * batch_mean
    return torch.where(cnt > 0, upd, codebooks)
