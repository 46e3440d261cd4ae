"""Closed-loop serving through ``repro_torch.search.Engine`` over an IVF-PQ
index.

Set-up: the deployment's data, the same for every seed (drawn from the
configuration's ``data_seed``): a SIFT-like corpus and query pool from one
mixture, a random rotation R, the coarse centroids and residual codebooks
fitted by the plain k-means of ``perfbench/reference`` on a sample of the
rotated corpus. The seed orders the pool and draws the checked sample. The program encodes every row (``index.ivf.encode``),
lays the index out (``index.ivf.pack``), and serves it through
``search.make("ivf")`` and ``search.Engine`` at its defaults.

Window: one client sends batches of distinct queries from the pool in
order, keeping ``in_flight`` batches submitted: it submits the next batch
before it collects the oldest. A batch's latency runs from the call of
``Engine.submit`` to the return of its ``Engine.collect``.

After the window: every answer's ids are valid and distinct and its scores
finite and descending; a sample of the answers, drawn from the seed, is
held to the plain IVF-PQ search of ``reference/ivf_pq.py`` over its own
encode of the corpus with the same quantizers.

Traffic keys: ``batch``, ``k``, ``nprobe``, ``queries`` (the pool),
``warmup_batches``, ``in_flight``, ``check_queries``.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import ivf_pq as ref
from perfbench.traffic.sift_like import sift_like
from perfbench.work import peaks
from perfbench.work import serve as work


def setup_inputs(cell: harness.Cell):
    """The corpus (device), the query pool (host) in the seed's order, R
    and the quantizers. The corpus, pool, R and quantizers are the
    deployment's data, drawn from the configuration's ``data_seed``, so
    every seed serves the same index and the same queries; ``--seed``
    orders the pool."""
    cfg, t = cell.config, cell.workload["traffic"]
    n, N = cfg["embed_dim"], cfg["item_vocab"]
    ivf, D, K = cfg["ivf"], cfg["index"]["num_subspaces"], \
        cfg["index"]["num_codewords"]
    g = torch.Generator(device=cell.device)
    g.manual_seed(cfg["data_seed"])
    allx = sift_like(g, N + t["queries"], n)
    order = np.random.RandomState(cell.numpy_seed("order")).permutation(
        t["queries"])
    X, pool = allx[:N], allx[N:].cpu().numpy()[order]
    R, _ = torch.linalg.qr(torch.randn((n, n), generator=g,
                                       device=cell.device))
    XT = X[:ivf["train_size"]] @ R
    gk = g
    centroids = ref.kmeans(gk, XT, ivf["num_lists"], ivf["kmeans_iters"])
    res = XT - centroids[ref.nearest(XT, centroids)]
    codebooks = ref.fit_pq(gk, res, D, K, ivf["kmeans_iters"])
    return X, pool, R.contiguous(), centroids.contiguous(), \
        codebooks.contiguous()


def build_index(X, R, centroids, codebooks, block_size: int):
    """The program's index over X with the given quantizers."""
    from repro_torch import quant
    from repro_torch.index import ivf as pivf

    coarse, pq = quant.VQ(centroids), quant.PQ(codebooks)
    lists, codes = [], []
    for s in range(0, X.shape[0], pivf.ENCODE_ROWS * 16):
        li, co = pivf.encode(X[s:s + pivf.ENCODE_ROWS * 16] @ R, coarse, pq)
        lists.append(li)
        codes.append(co)
    ids = torch.arange(X.shape[0], dtype=torch.int32)
    return pivf.pack(R, coarse, pq, torch.cat(codes), torch.cat(lists), ids,
                     block_size=block_size)


def serve(engine, pool: np.ndarray, starts, in_flight: int, deadline=None):
    """Drive the Engine over batches pool[s:s+b] for s in ``starts`` until
    they run out or the host clock passes ``deadline``. Returns
    (batches served in order as (start, SearchResult), latencies s,
    submit host times s)."""
    b = int(starts.step)
    pending = collections.deque()
    done, lat, sub = [], [], []
    for s in starts:
        if deadline is not None and time.perf_counter() >= deadline:
            break
        t0 = time.perf_counter()
        p = engine.submit(pool[s:s + b])
        sub.append(time.perf_counter() - t0)
        pending.append((t0, s, p))
        if len(pending) >= in_flight:
            t, s0, p0 = pending.popleft()
            done.append((s0, engine.collect(p0)))
            lat.append(time.perf_counter() - t)
    while pending:
        t, s0, p0 = pending.popleft()
        done.append((s0, engine.collect(p0)))
        lat.append(time.perf_counter() - t)
    return done, lat, sub


def bad_rows(ids: torch.Tensor, scores: torch.Tensor, N: int) -> int:
    """Rows whose ids are out of range or repeated, or whose scores are
    not finite and descending."""
    s = torch.sort(ids.long(), dim=1).values
    bad = ((ids < 0) | (ids >= N)).any(1) | (s[:, 1:] == s[:, :-1]).any(1)
    bad |= ~torch.isfinite(scores).all(1)
    bad |= (scores[:, 1:] > scores[:, :-1]).any(1)
    return int(bad.sum())


def compare(ids, scores, ref_ids, ref_scores) -> tuple[float, float]:
    """(share of answer slots whose id is not among the reference's top k
    for that query; 90th percentile over the slots of the score gap at the
    same rank, relative to the query's largest reference score)."""
    miss = ~(ids.long()[:, :, None] == ref_ids[:, None, :]).any(2)
    scale = ref_scores.abs().amax(1, keepdim=True).clamp(min=1e-30)
    gap = ((scores - ref_scores).abs() / scale).reshape(-1)
    return float(miss.float().mean()), float(torch.quantile(gap.double(), 0.9))


def run(cell: harness.Cell) -> dict:
    from repro_torch import search

    cfg, t = cell.config, cell.workload["traffic"]
    N = cfg["item_vocab"]
    b, k, nprobe = t["batch"], t["k"], t["nprobe"]
    X, pool, R, centroids, codebooks = setup_inputs(cell)
    index = build_index(X, R, centroids, codebooks, cfg["ivf"]["block_size"])
    searcher = search.make("ivf")
    engine = search.Engine(searcher, searcher.attach(index, nprobe=nprobe),
                           k=k, nprobe=nprobe)
    max_blocks = engine.state.max_blocks
    nb = (t["queries"] - t["warmup_batches"] * b) // b
    serve(engine, pool, range(nb * b, t["queries"] - b + 1, b),
          t["in_flight"])

    with cell.window() as t0:
        served, lat, sub = [], [], []
        deadline = t0 + cell.seconds
        while time.perf_counter() < deadline:
            d, la, su = serve(engine, pool, range(0, nb * b, b),
                              t["in_flight"], deadline)
            served += d
            lat += la
            sub += su
    window_s = cell.window_s
    queries = len(served) * b
    bad = sum(bad_rows(r.ids, r.scores, N) for _, r in served)
    answers = [(s, r.ids.cpu(), r.scores.cpu()) for s, r in served]
    del engine, searcher, index, served
    harness.free()

    # the reference: its own encode of the corpus, then a sample of the
    # answers searched again
    rix = ref.build(X, R, centroids, codebooks)
    rng = np.random.RandomState(cell.numpy_seed("check"))
    pick = rng.choice(queries, size=min(t["check_queries"], queries),
                      replace=False)
    rows = np.array([answers[i // b][0] + i % b for i in pick])
    got_ids = torch.stack([answers[i // b][1][i % b] for i in pick])
    got_sc = torch.stack([answers[i // b][2][i % b] for i in pick])
    q = torch.from_numpy(pool[rows]).to(cell.device)
    want_sc, want_ids = ref.search(rix, q, R, centroids, codebooks, nprobe, k)
    miss, gap = compare(got_ids.to(cell.device), got_sc.to(cell.device),
                        want_ids, want_sc)
    cell.check("bad_rows", bad, cell.limit("bad_rows"))
    cell.check("id_miss_share", miss, cell.limit("id_miss_share"))
    cell.check("score_gap_p90", gap, cell.limit("score_gap_p90"))

    out = dict(attempted=queries, failed=bad,
               e2e=dict(serve_qps=queries / window_s,
                        serve_p95_ms=float(np.percentile(lat, 95)) * 1e3),
               host=dict(submit_s=sub, batches=len(answers), queries=queries),
               card=dict(batches=len(answers), max_blocks=max_blocks))
    if cell.trace:
        out["work"] = window_work(cell, rix, centroids, R, pool,
                                  [s for s, _, _ in answers])
        out["card"].update(mfu_bound=peaks.bound_s(
            out["work"]["flops"], out["work"]["bytes"])[1])
    return out


def window_work(cell, rix, centroids, R, pool, starts) -> dict:
    """The work of the window's batches, counted from the lists each query
    probes in the reference's encode."""
    cfg, t = cell.config, cell.workload["traffic"]
    n, L = cfg["embed_dim"], cfg["ivf"]["num_lists"]
    D, K = cfg["index"]["num_subspaces"], cfg["index"]["num_codewords"]
    b, k, nprobe = t["batch"], t["k"], t["nprobe"]
    sizes = ref.list_sizes(rix)
    probed_of = {}
    flops = nbytes = scan = 0.0
    for s in starts:
        if s not in probed_of:
            q = torch.from_numpy(pool[s:s + b]).to(cell.device)
            probed = ref.probe(q, R, centroids, nprobe)[2]
            per_query = int(sizes[probed].sum())
            seen = torch.zeros(L, dtype=torch.bool, device=cell.device)
            seen[probed.reshape(-1)] = True
            probed_of[s] = (per_query, int(sizes[seen].sum()))
        per_query, union = probed_of[s]
        flops += work.batch_flops(b, n, L, D, K, per_query)
        nbytes += work.batch_bytes(b, n, L, D, K, k, union)
        scan += work.scan_bytes(b, D, K, union, per_query)
    return dict(flops=flops, bytes=nbytes, scan_bytes=scan)


def control(cell: harness.Cell) -> dict:
    """The numbers the control reads: the reference computed in TF32 in the
    program's place, held to the float32 reference on a sample of the
    pool's queries."""
    t = cell.workload["traffic"]
    X, pool, R, centroids, codebooks = setup_inputs(cell)
    rng = np.random.RandomState(cell.numpy_seed("check"))
    pick = rng.choice(len(pool), size=t["check_queries"], replace=False)
    q = torch.from_numpy(pool[pick]).to(cell.device)
    answers = {}
    for precision in ("tf32", "float32"):
        rix = ref.build(X, R, centroids, codebooks, precision)
        answers[precision] = ref.search(rix, q, R, centroids, codebooks,
                                        t["nprobe"], t["k"], precision)
        del rix
    (got_sc, got_ids), (want_sc, want_ids) = answers["tf32"], \
        answers["float32"]
    miss, gap = compare(got_ids, got_sc, want_ids, want_sc)
    return dict(bad_rows=bad_rows(got_ids, got_sc, cell.config["item_vocab"]),
                id_miss_share=miss, score_gap_p90=gap)
