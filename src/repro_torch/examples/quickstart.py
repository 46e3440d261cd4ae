"""Quickstart: learn a rotation with Givens coordinate descent (paper §3.1),
port of ``examples/quickstart.py``.

Generates anisotropic SIFT-like vectors, then compares rotation learners on
fixed embeddings:
  * classic OPQ (SVD Procrustes)     — the baseline GCD replaces
  * GCD-G (greedy, paper Algorithm 1+2) and GCD-S (steepest)
  * frozen identity rotation         — lower bound

and finishes by serving the GCD-rotated corpus through every backend of
the port's retrieval registry (``repro_torch.search.names()``): exact
brute force (tiled and streaming), flat ADC, probed IVF, and their three
row-sharded twins over one shard a visible card (the JAX script's mesh
over every device; one shard on the CPU with ``--device cpu``).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import device as _device
from repro_torch import rotations, search
from repro_torch.data import synthetic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.metrics import recall_at_k
from repro_torch.quant import PQConfig, opq

SOLVERS = (("frozen", {}), ("procrustes", {}),
           ("gcd_greedy", dict(inner_steps=5, lr=2e-3)),
           ("gcd_steepest", dict(inner_steps=5, lr=2e-3)))


def main(argv=None, *, num: int = 4096, dim: int = 64, iters: int = 25,
         queries: int = 64) -> dict:
    """The example at the JAX script's sizes (the keywords shrink it for a
    test); returns what it prints: each learner's distortion trace ends
    and orthogonality error, and each backend's recall@10 and rows
    scanned a query."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    X = synthetic.sift_like(_device.generator(0, dev), num, dim, device=dev)
    cfg = PQConfig(num_subspaces=8, num_codewords=32)
    print(f"data: {tuple(X.shape)}, PQ D={cfg.num_subspaces} "
          f"K={cfg.num_codewords}")

    learners, R_best = {}, None
    for solver, kw in SOLVERS:
        R, _cb, trace = opq.alternating_minimization(
            _device.generator(1, dev), X, cfg, iters=iters, rotation=solver,
            **kw)
        tr = trace.tolist()
        ortho = float(rotations.orthogonality_error(R))
        learners[solver] = dict(distortion_first=tr[0], distortion_last=tr[-1],
                                orthogonality_error=ortho)
        print(f"{solver:14s} distortion {tr[0]:.4f} → {tr[-1]:.4f}   "
              f"‖RᵀR−I‖={ortho:.2e}")
        if solver == "gcd_greedy":
            R_best = R
    print("\nGCD matches OPQ without a single SVD — and it drops straight "
          "into an SGD loop (see repro_torch.examples.train_twotower).")

    # --- serve the learned rotation through the search registry
    Q = synthetic.sift_like(_device.generator(7, dev), queries, dim,
                            device=dev)
    scfg = search.SearchConfig(num_lists=16, subspaces=cfg.num_subspaces,
                               codewords=cfg.num_codewords, nprobe=4)
    oracle = search.make("exact")
    oracle_state = oracle.build(_device.generator(8, dev), X, R_best, scfg,
                                device=dev)
    truth = oracle.search(oracle_state, Q, k=10).ids
    backends = {}
    mesh = (mesh_lib.make_data_mesh() if dev.type == "cuda"
            else mesh_lib.make_data_mesh(devices=(dev,)))
    print("\nbackend       recall@10  scanned rows/query")
    for backend in search.names():
        kw = {"mesh": mesh} if backend.endswith("_sharded") else {}
        searcher = search.make(backend, **kw)
        state = (oracle_state if backend == "exact" else
                 searcher.build(_device.generator(8, dev), X, R_best, scfg,
                                device=dev))
        res = searcher.search(state, Q, k=10)
        rec = recall_at_k(res.ids, truth)
        scanned = float(res.scanned.double().mean())
        backends[backend] = dict(recall=rec, scanned=scanned)
        if kw:
            backends[backend]["shards"] = len(mesh.devices)
        print(f"{backend:12s}  {rec:9.3f}  {scanned:8.0f}")
    print("one Searcher API — exact is the oracle, flat_adc pays only "
          "quantization, ivf adds the probe trade-off, and each has a "
          "row-sharded twin (see repro_torch.search).")
    return dict(data=list(X.shape), learners=learners, backends=backends)


if __name__ == "__main__":
    main()
