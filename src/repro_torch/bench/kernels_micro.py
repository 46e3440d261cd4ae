"""Kernel micro-benchmarks (port of ``benchmarks/kernels_micro.py``):
``PYTHONPATH=src python -m repro_torch.bench.kernels_micro [--device cpu]``.

The JAX script's rows at its shapes: ``givens_rotate`` (8,192 × 512),
``gcd_score`` at n = 512 and its plain row ``gcd_score_ref``,
``pq_assign`` (16,384 × 512) × (64, 256, 8), ``adc_lookup`` b = 8 over
65,536 × 64 in float32 and in the int8 (or uint8) pack with its top-10
agreement and modeled ``bytes_ratio`` ≥ 2, ``embedding_bag`` (100k × 64,
16,384 indices in 2,048 bags), ``fused_lut`` (8, 512, 64, 256, 8), the
streaming top-k merge (``stream_merge``: tile-order invariance of the
fold) and the Engine's fused refresh (``fused_refresh``: no new
executable, no LUT invalidation, every cached row reused).

Each row's ``ok`` is the kernel against its plain version by the JAX
script's checks (``pq_assign``: equal codes, or each differing code a
float32 tie — the card's kernel sums in another order; the flips are
counted). On the card ``us_per_call`` is the hand-written kernel's device
time (``device_us``: back-to-back launches in a CUDA graph), ``plain_us``
its plain version's, and ``predicted_us`` the port's roofline bound
(``roofline.analysis.kernel_predicted`` at the float32 rate over the bytes
each operand moves once); on the CPU ``us_per_call`` is the plain path's
host time and there is no ``plain_us``.
"""
from __future__ import annotations

import argparse
import math
import statistics
import time

import torch

from repro_torch import device as _device
from repro_torch.bench import common
from repro_torch.kernels import ops, ref
from repro_torch.roofline import analysis

#: a pq_assign code that differs from the plain version's by no more than
#: this share of the scores' scale is a float32 tie
TIE_GAP = 1e-5


def device_us(fn, dev: torch.device, launches: int = 20, reps: int = 5
              ) -> float:
    """µs per call of ``fn``: on the card ``launches`` calls captured back
    to back in one CUDA graph, replayed ``reps`` times between CUDA events
    (the median replay over ``launches``: device time, the host's enqueue
    left out); on the CPU the median host time of a call."""
    if dev.type != "cuda":
        return common.time_call(fn, dev, warmup=1, iters=reps)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / launches)
    del graph
    return statistics.median(times)


def _bytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _topk_agree(a, b) -> float:
    """Mean per-row overlap of two (b, k) id sets."""
    a, b = a.cpu().tolist(), b.cpu().tolist()
    return statistics.mean(len(set(x) & set(y)) / len(x)
                           for x, y in zip(a, b))


def _assign_flips(X, C, got, want) -> dict:
    """Codes that differ from the plain version's, and the largest score
    gap between the two choices over the scores' scale."""
    diff = got != want
    n = int(diff.sum())
    if not n:
        return dict(flips=0, max_gap=0.0)
    m, D = got.shape
    sub = C.shape[2]
    Xs = X.reshape(m, D, sub)
    score = (C * C).sum(-1)[None] - 2 * torch.einsum("mds,dks->mdk", Xs, C)
    a = score.gather(2, got.long()[..., None])[..., 0]
    b = score.gather(2, want.long()[..., None])[..., 0]
    gap = ((a - b).abs()[diff] / score.abs().amax()).max()
    return dict(flips=n, max_gap=float(gap))


def run(verbose: bool = True, lut_dtype: str = "int8", device=None) -> dict:
    """Returns ``{kernel: {"ok", "us_per_call", ...}}``: the check and the
    time, with ``plain_us`` and ``predicted_us`` on the card."""
    dev = _device.resolve(device)
    card = dev.type == "cuda"
    g = _device.generator(0, dev)
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def record(name, ok, kernel, plain, flops, nbytes, **extra):
        row = {"ok": bool(ok)}
        row["us_per_call"] = device_us(kernel if card else plain, dev)
        if card and kernel is not plain:
            row["plain_us"] = device_us(plain, dev, launches=5)
        if flops is not None:
            pred = analysis.kernel_predicted(flops, nbytes)
            row.update(predicted_us=pred["predicted_us"],
                       dominant=pred["dominant"], flops=flops,
                       bytes_model=nbytes)
        row.update(extra)
        results[name] = row
        if verbose:
            common.emit("kernels", name, **row)

    # givens_rotate @ (m=8192, n=512), n/2 disjoint pairs
    m, n = 8192, 512
    X = randn(m, n)
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    pi, pj = perm[: n // 2].contiguous(), perm[n // 2:].contiguous()
    theta = randn(n // 2)
    c, s = torch.cos(theta), torch.sin(theta)
    got = ops.givens_rotate(X, pi, pj, c, s)
    want = ref.pair_rotate_ref(X, pi, pj, c, s)
    ok = torch.allclose(got, want, atol=1e-4)
    record("givens_rotate", ok, lambda: ops.givens_rotate(X, pi, pj, c, s),
           lambda: ref.pair_rotate_ref(X, pi, pj, c, s),
           6.0 * m * (n // 2), _bytes(X, got, pi, pj, c, s))

    # gcd_score @ n=512, and the plain version as its own row
    G, R = randn(512, 512), randn(512, 512)
    ok = torch.allclose(ops.gcd_score(G, R), ref.gcd_score_ref(G, R),
                        atol=1e-2)
    record("gcd_score", ok, lambda: ops.gcd_score(G, R),
           lambda: ref.gcd_score_ref(G, R), 2.0 * 512 ** 3,
           _bytes(G, R, G))
    def plain():
        return ref.gcd_score_ref(G, R)
    record("gcd_score_ref", True, plain, plain, None, None)

    # pq_assign @ (m=16384, n=512, D=64, K=256)
    Xq, cb = randn(16384, 512), randn(64, 256, 8)
    got, want = ops.pq_assign(Xq, cb), ref.pq_assign_ref(Xq, cb)
    flips = _assign_flips(Xq, cb, got, want)
    ok = flips["flips"] == 0 or flips["max_gap"] <= TIE_GAP
    record("pq_assign", ok, lambda: ops.pq_assign(Xq, cb),
           lambda: ref.pq_assign_ref(Xq, cb), 2.0 * 16384 * 512 * 256,
           _bytes(Xq, cb, got), **flips)

    # adc_lookup @ (b=8, D=64, K=256, N=65536)
    b, Dp, K, N, blk = 8, 64, 256, 65536, 1024
    lut = randn(b, Dp, K)
    codes = torch.randint(0, K, (N, Dp), generator=g, device=dev,
                          dtype=torch.uint8)
    got = ops.adc_lookup(lut, codes)
    base = ref.adc_lookup_ref(lut, codes)
    ok = torch.allclose(got, base, atol=1e-3)
    record("adc_lookup", ok, lambda: ops.adc_lookup(lut, codes),
           lambda: ref.adc_lookup_ref(lut, codes), float(b * N * Dp),
           _bytes(lut, codes, got))

    # adc_lookup with the int8/uint8 table pack: parity on the pack, top-10
    # against the float32 tables, and the modeled traffic the pack saves
    qlut, scales = ops.quantize_luts(lut, lut_dtype)
    got_q = ops.adc_lookup(qlut, codes, scales)
    want_q = ref.adc_lookup_ref(qlut, codes, scales)
    agree = _topk_agree(torch.topk(got_q, 10, dim=1).indices,
                        torch.topk(base, 10, dim=1).indices)
    bytes_f32 = analysis.adc_scan_traffic(b, Dp, K, N // blk, blk, "float32",
                                          luts_per_step=b)
    bytes_q = analysis.adc_scan_traffic(b, Dp, K, N // blk, blk, lut_dtype,
                                        luts_per_step=b)
    ratio = bytes_f32 / bytes_q
    ok = (torch.allclose(got_q, want_q, atol=1e-3) and agree >= 0.9
          and ratio >= 2.0)
    record(f"adc_lookup_{lut_dtype}", ok,
           lambda: ops.adc_lookup(qlut, codes, scales),
           lambda: ref.adc_lookup_ref(qlut, codes, scales),
           float(b * N * Dp + 2 * b * Dp * K), bytes_q, topk_agree=agree,
           bytes_ratio=float(ratio))

    # embedding_bag @ (V=100k, dim=64, L=16384 in 2048 bags)
    table = randn(100_000, 64)
    idx = torch.randint(0, 100_000, (16384,), generator=g, device=dev,
                        dtype=torch.int32)
    bags = torch.sort(torch.randint(0, 2048, (16384,), generator=g,
                                    device=dev, dtype=torch.int32))[0]
    got = ops.embedding_bag(table, idx, bags, 2048)
    want = ref.embedding_bag_ref(table, idx, bags, 2048)
    ok = torch.allclose(got, want, atol=1e-3)
    record("embedding_bag", ok,
           lambda: ops.embedding_bag(table, idx, bags, 2048),
           lambda: ref.embedding_bag_ref(table, idx, bags, 2048),
           2.0 * 16384 * 64,
           _bytes(idx, bags, got) + 16384 * 64 * 4.0)

    # fused rotation-aware LUT build @ (b=8, n=512, Dp=64, K=256, sub=8)
    n, sub = 512, 8
    Qf = randn(8, n)
    qdelta = randn(n, n) / math.sqrt(n)
    cbf = randn(Dp, K, sub)
    colmap = torch.eye(Dp, device=dev)
    cols = ops.lut_column_map(colmap)
    got = ops.fused_lut(Qf, qdelta, cbf, colmap, cols=cols)
    want = ref.fused_lut_ref(Qf, qdelta, cbf, colmap)
    ok = torch.allclose(got, want, atol=1e-3)
    record("fused_lut", ok,
           lambda: ops.fused_lut(Qf, qdelta, cbf, colmap, cols=cols),
           lambda: ref.fused_lut_ref(Qf, qdelta, cbf, colmap),
           2.0 * 8 * n * n + 2.0 * 8 * Dp * K * sub,
           analysis.fused_lut_traffic(8, n, Dp, K, sub))

    # streaming top-k merge: the fold of the streaming exact scan does not
    # depend on the tiles' order and equals a one-shot top-k
    sc = randn(8, 16384)
    tiles = [(sc[:, i:i + 2048],
              torch.arange(i, i + 2048, device=dev, dtype=torch.int32))
             for i in range(0, 16384, 2048)]

    def fold(order):
        acc_s = torch.full((8, 10), -math.inf, device=dev)
        acc_i = torch.full((8, 10), -1, device=dev, dtype=torch.int32)
        for t in order:
            s_t, i_t = tiles[t]
            acc_s, acc_i = ops.topk_merge(
                torch.cat([acc_s, s_t], 1),
                torch.cat([acc_i, i_t[None].expand(8, -1)], 1), 10)
        return acc_s, acc_i

    s1, i1 = fold(range(len(tiles)))
    s2, i2 = fold(reversed(range(len(tiles))))
    oneshot = torch.topk(sc, 10, dim=1).indices
    ok = (torch.equal(i1, i2) and torch.equal(s1, s2)
          and torch.equal(torch.sort(i1.long(), 1)[0],
                          torch.sort(oneshot, 1)[0]))
    results["stream_merge"] = {
        "ok": bool(ok), "us_per_call": common.time_call(
            lambda: fold(range(len(tiles))), dev)[0]}
    if verbose:
        common.emit("kernels", "stream_merge", **results["stream_merge"])

    # the Engine's fused refresh on a small live index: a within-subspace
    # delta costs no new executable and no table invalidation, and the
    # next search reuses every cached table row
    from repro_torch import rotations, search
    dim, rows = 64, 4096
    Xs = randn(rows, dim)
    Rs = rotations.random_rotation(g, dim, device=dev)
    cfg = search.SearchConfig(subspaces=8, codewords=16, lut_dtype=lut_dtype,
                              fused_refresh=True)
    searcher = search.make("flat_adc")
    state = searcher.build(_device.generator(2, dev), Xs, Rs, cfg,
                           device=dev)
    eng = search.Engine(searcher, state, k=10, min_bucket=4)
    Qs = randn(8, dim)
    eng.search(Qs)
    compiles0 = eng.stats()["compiles"]
    learner = rotations.make("subspace_gcd", sub=dim // 8)
    _, delta = learner.update(learner.init_from(Rs), randn(dim, dim), 1e-3,
                              _device.generator(5, dev))
    common.sync(dev)
    t0 = time.perf_counter()
    eng.refresh(delta)
    common.sync(dev)
    refresh_us = (time.perf_counter() - t0) * 1e6
    eng.search(Qs)
    st = eng.stats()
    ok = (st["compiles"] == compiles0 and st["lut_invalidations"] == 0
          and st["lut_hits"] >= 8)
    results["fused_refresh"] = dict(
        ok=bool(ok), us_per_call=refresh_us, compiles=int(st["compiles"]),
        lut_invalidations=int(st["lut_invalidations"]),
        lut_hits=int(st["lut_hits"]))
    if verbose:
        common.emit("kernels", "fused_refresh", **results["fused_refresh"])
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lut-dtype", default="int8", choices=("int8", "uint8"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    results = run(lut_dtype=args.lut_dtype, device=dev)
    bad = [k for k, v in results.items() if not v["ok"]]
    common.emit("kernels", "summary", failed=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
