"""ANN serving example: a GCD-learned rotation deployed behind
``search.Engine`` (port of ``examples/serve_ann.py``).

The serving path is the paper's T(X) = φ(XR)Rᵀ deployed at production shape
through the port's retrieval subsystem (``repro_torch.search``):
  * offline: learn (R, codebooks) with GCD, then ``search.make("ivf")``
    builds the IVF-PQ index — k-means coarse lists over XR plus residual
    PQ codes in a block-aligned CSR layout;
  * online: ``search.Engine`` serves ragged query batches — each batch is
    bucketized to a padded shape, one executable per (bucket, k, nprobe),
    and repeated queries reuse their cached ADC LUTs;
  * continuously: after a GCD training step the learner's RotationDelta
    is fed to ``engine.refresh`` — centroids and codebooks absorb it in
    O(n²) and the index stays servable with no new executable and no
    corpus re-encode.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_ann [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import rotations, search
from repro_torch.bench import common
from repro_torch.data import synthetic
from repro_torch.index import maintain
from repro_torch.metrics import recall_at_k
from repro_torch.quant import PQConfig, opq

SPANS = ((0, 96), (96, 153), (153, 256), (0, 256))


def main(argv=None, *, N: int = 100_000, dim: int = 64, D: int = 16,
         K: int = 256, L: int = 256, learn_rows: int = 8192,
         opq_iters: int = 15, train_size: int = 16384,
         queries: int = 256) -> dict:
    """The example at the JAX script's sizes (the keywords shrink it for a
    test); returns what it prints: the rotation's distortion, the index's
    stats, each nprobe's Engine stats and recall@10 against ``exact``, and
    the refresh's seconds, orthogonality drift, code mismatch,
    executables before and after, and recall after it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    corpus = synthetic.sift_like(_device.generator(0, dev), N, dim,
                                 device=dev)
    Q = synthetic.sift_like(_device.generator(1, dev), queries, dim,
                            device=dev)
    out: dict = dict(corpus=[N, dim])
    print(f"corpus {N}×{dim} (f32: {N * dim * 4 / 2**20:.0f} MiB)")
    t0 = time.perf_counter()
    R, _cb, trace = opq.alternating_minimization(
        _device.generator(2, dev), corpus[:learn_rows], PQConfig(D, K),
        iters=opq_iters, rotation="gcd_greedy", inner_steps=5, lr=2e-3)
    common.sync(dev)
    out["learn"] = dict(seconds=time.perf_counter() - t0,
                        distortion_first=float(trace[0]),
                        distortion_last=float(trace[-1]))
    print(f"rotation learned in {out['learn']['seconds']:.1f}s (distortion "
          f"{float(trace[0]):.3f} → {float(trace[-1]):.3f})")

    # --- build the IVF backend on the learned rotation
    cfg = search.SearchConfig(num_lists=L, subspaces=D, codewords=K,
                              block_size=128, nprobe=32,
                              train_size=train_size)
    searcher = search.make("ivf")
    t0 = time.perf_counter()
    state = searcher.build(_device.generator(3, dev), corpus, R, cfg,
                           device=dev)
    common.sync(dev)
    st = searcher.stats(state)
    out["index"] = dict(seconds=time.perf_counter() - t0,
                        num_lists=st["num_lists"], capacity=st["capacity"],
                        memory_bytes=st["memory_bytes"],
                        compression=st["compression"])
    print(f"index built in {out['index']['seconds']:.1f}s: "
          f"{st['num_lists']} lists, cap {st['capacity']} rows, codes "
          f"≈{st['memory_bytes'] / 2**20:.0f} MiB "
          f"({st['compression']:.0f}× compression)")

    # --- ground truth through the same registry: the exact backend
    exact = search.make("exact")
    truth = exact.search(exact.build(None, corpus, R, cfg, device=dev), Q,
                         k=10).ids

    # --- serve ragged batches through the Engine at a few nprobe settings
    out["engines"] = {}
    for nprobe in (8, 32):
        engine = search.Engine(searcher, state, k=10, nprobe=nprobe,
                               min_bucket=32)
        ids = [engine.search(Q[lo:hi]).ids for lo, hi in SPANS]
        es = engine.stats()
        rec = recall_at_k(torch.cat(ids[:3]), truth)
        out["engines"][nprobe] = dict(
            requests=es["requests"], queries=es["queries"],
            compiles=es["compiles"], executables=es["executables"],
            lut_hit_rate=es["lut_hit_rate"],
            latency_ms_p50=es["latency_ms_p50"],
            scanned_rows_mean=es["scanned_rows_mean"], recall=rec)
        print(f"nprobe={nprobe:3d}: {es['requests']} ragged batches "
              f"({es['queries']} queries) -> {es['compiles']} compiles, "
              f"LUT hit rate {es['lut_hit_rate']:.2f}, "
              f"p50 {es['latency_ms_p50']:.1f} ms, scanned "
              f"{es['scanned_rows_mean']:.0f}/{st['capacity']} rows/query, "
              f"recall@10 vs exact {rec:.3f}")

    # --- keep serving across a GCD training step: refresh, don't rebuild
    engine = search.Engine(searcher, state, k=10, nprobe=32, min_bucket=32)
    before = engine.search(Q).ids      # the executable cache warmed
    executables = engine.stats()["executables"]
    quantizer = state.index.quantizer
    G = opq.distortion_grad_wrt_R(corpus[:learn_rows], state.index.R,
                                  quantizer.codebooks)
    learner = rotations.make("subspace_gcd", sub=quantizer.sub)
    _, delta = learner.update(learner.init_from(state.index.R), G, 2e-3,
                              _device.generator(4, dev))
    # a throwaway refresh first: the refresh's cost, not its first call's
    searcher.refresh(engine.state, delta)
    common.sync(dev)
    t0 = time.perf_counter()
    engine.refresh(delta)
    common.sync(dev)
    dt = time.perf_counter() - t0
    after = engine.search(Q).ids
    es = engine.stats()
    out["refresh"] = dict(
        seconds=dt,
        orthogonality_drift=float(rotations.orthogonality_error(
            engine.state.index.R)),
        refresh_mismatch=maintain.refresh_mismatch(engine.state.index,
                                                   corpus),
        executables_before=executables, executables_after=es["executables"],
        compiles=es["compiles"], recall_before=recall_at_k(before, truth),
        recall_after=recall_at_k(after, truth))
    r = out["refresh"]
    print(f"engine.refresh after GCD step: {dt:.3f}s, orthogonality drift "
          f"{r['orthogonality_drift']:.2e}, code mismatch vs full re-encode "
          f"{r['refresh_mismatch'] * 100:.2f}%, executables after refresh: "
          f"{r['executables_after']} (before: {r['executables_before']})")
    print(f"post-refresh recall@10 vs exact: {r['recall_after']:.3f} "
          f"(before: {r['recall_before']:.3f})")
    return out


if __name__ == "__main__":
    main()
