"""Recall@10 against QPS across the search registry, for PQ and RQ indexes
(port of ``benchmarks/ivf_recall_qps.py``).

One harness over every backend the port registers. Per residual depth (PQ
at depth 1, RQ above) it builds a rotated IVF index and serves the same
corpus, queries and rotation through each searcher:

  * ``exact``: tiled brute force, the recall oracle; ``exact_stream``
    must give its ids;
  * ``flat_adc``: the full ADC scan over the very codes ``ivf`` probes
    (recall against it isolates the probe's loss), with float32 and int8
    tables;
  * ``ivf``: the nprobe sweep, rows scanned against recall;
  * a ``subspace_gcd`` delta through ``Searcher.refresh``, and at depth 1
    the Engine's executables over ragged batches and a fused-refresh
    Engine's refresh;
  * the sharded twins (``exact_sharded``, ``flat_sharded``,
    ``ivf_sharded``) on the same artifacts over the run's shard mesh,
    held to recall ≥ 0.999 against their replicated twins
    (``sharded_parity``).

The checks are the JAX script's: ``streaming_matches_exact``,
``<scheme>_int8_recall_within_0.01``, ``pq_scan_reduction_at_recall``
(some nprobe at recall ≥ 0.9 against the flat scan with a ≥ 5× scan
reduction), ``engine_compile_cache`` (the port's "compiles" are the
Engine's executables), ``fused_refresh_no_recompile``,
``fused_refresh_no_lut_invalidation``, ``rq<M>_end_to_end`` (refresh
mismatch ≤ 0.01 and recall after it), ``rq_beats_pq_quantization``
(residual distortion strictly lower, flat recall no lower) and
``registry_swept`` over the port's ``search.names()``.

``--devices N`` shards the index N ways: the twins' rows run on N shards,
and the JAX script's sharded cell (``sharded_cell``: the single-device
``ivf`` against ``ivf_sharded`` on the same index, an Engine's refresh
over the sharded state) adds ``sharded_scan_linear`` (rows scanned a shard
within 2× of 1/N of the single device's), ``sharded_recall_unchanged``
and ``sharded_refresh_no_recompile``. One shard goes on each visible
card; with fewer cards than N the run raises unless ``--shard-device``
names where the shards go (``cuda:0`` lays all N on one card, ``cpu``
on the CPU; or a comma list of N devices). Several shards on one card
measure per-shard work and parity, not the speed of several cards.

    PYTHONPATH=src python -m repro_torch.bench.ivf_recall_qps [--n 100000]
        [--depths 1,2] [--device cpu] [--devices 4 --shard-device cuda:0]

prints JSON lines (a row per backend and nprobe, the checks, the device)
and exits 1 when a check fails; it writes no file.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import rotations, search
from repro_torch.bench import common
from repro_torch.core import givens
from repro_torch.data import synthetic
from repro_torch.index import maintain
from repro_torch.metrics import recall_at_k


def emit(name: str, **fields) -> None:
    common.emit("ivf_recall_qps", name, **fields)


def _bench(fn, dev: torch.device, reps: int = 3) -> float:
    """Seconds per call of ``fn`` after one warm-up call, the device
    synchronised around the timed calls."""
    fn()
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    common.sync(dev)
    return (time.perf_counter() - t0) / reps


def sharded_cell(X, Q, R, cfg, mesh, truth, nprobe: int = 8) -> dict:
    """The JAX script's sharded cell: the single-device ``ivf`` against
    ``ivf_sharded`` on the same index over ``mesh``, rows scanned a shard,
    recall, and an Engine over the sharded state through a subspace-GCD
    refresh (its new executables)."""
    ivf_s = search.make("ivf")
    dev = mesh.devices[0]
    single = ivf_s.build(_device.generator(3, dev), X, R, cfg, device=dev)
    res_single = ivf_s.search(single, Q, k=10, nprobe=nprobe)
    scan_single = float(res_single.scanned.float().mean())
    sh_s = search.make("ivf_sharded", mesh=mesh)
    state = sh_s.attach(single.index, mesh=mesh, nprobe=nprobe)
    res = sh_s.search(state, Q, k=10)
    S = len(mesh.devices)
    per_dev = float(res.scanned.float().mean()) / S
    engine = search.Engine(sh_s, state, k=10, nprobe=nprobe, min_bucket=32)
    engine.search(Q)
    compiles = engine.stats()["compiles"]
    index = single.index
    Rp = index.R.clone().requires_grad_(True)
    (G,) = torch.autograd.grad(
        index.quantizer.distortion(X[:8192] @ Rp), Rp)
    learner = rotations.make("subspace_gcd", sub=index.quantizer.sub)
    _, delta = learner.update(learner.init_from(index.R), G, 2e-3)
    engine.refresh(delta)
    post = engine.search(Q)
    return dict(
        devices=S, shard_devices=[str(d) for d in mesh.devices],
        scan_single=scan_single, scan_per_device=per_dev,
        reduction_per_device=scan_single / max(per_dev, 1.0),
        recall_single=recall_at_k(res_single.ids, truth),
        recall_sharded=recall_at_k(res.ids, truth),
        parity=recall_at_k(res.ids, res_single.ids) >= 0.999,
        refresh_recompiles=engine.stats()["compiles"] - compiles,
        post_refresh_recall=recall_at_k(post.ids, truth))


def run(n: int = 100_000, dim: int = 64, queries: int = 256,
        lists: int = 256, subspaces: int = 16, codewords: int = 256,
        depths=(1, 2), verbose: bool = True, devices: int = 1,
        device=None, shard_device=None):
    """Sweep the registry × residual depths -> (results, checks) on
    ``device`` (the card unless the caller passes ``device="cpu"``), the
    sharded twins over ``devices`` shards (``common.shard_mesh``)."""
    out = emit if verbose else (lambda *a, **k: None)
    dev = _device.resolve(device)
    mesh = common.shard_mesh(devices, shard_device, dev)
    X = synthetic.sift_like(_device.generator(0, dev), n, dim, device=dev)
    Q = synthetic.sift_like(_device.generator(1, dev), queries, dim,
                            device=dev)
    R = givens.random_rotation(_device.generator(2, dev), dim, device=dev)

    results: dict = {}
    checks: dict = {}
    full_probe_recall: dict = {}
    swept = set()

    exact_s = search.make("exact")
    exact_state = exact_s.build(None, X, R,
                                search.SearchConfig(tile_rows=8192),
                                device=dev)
    exact_ids = exact_s.search(exact_state, Q, k=10).ids
    exact_dt = _bench(lambda: exact_s.search(exact_state, Q, k=10), dev)
    out("row", backend="exact", scan_rows=n, qps=queries / exact_dt,
        recall10_vs_exact=1.0)
    swept.add("exact")

    stream_s = search.make("exact_stream")
    stream_state = stream_s.build(None, X, R,
                                  search.SearchConfig(tile_rows=8192),
                                  device=dev)
    stream_res = stream_s.search(stream_state, Q, k=10)
    stream_dt = _bench(lambda: stream_s.search(stream_state, Q, k=10), dev)
    stream_exact = bool(torch.equal(stream_res.ids, exact_ids))
    out("row", backend="exact_stream", scan_rows=n,
        qps=queries / stream_dt, bit_identical=stream_exact)
    swept.add("exact_stream")
    checks["streaming_matches_exact"] = stream_exact
    results["exact_stream"] = dict(qps=queries / stream_dt,
                                   bit_identical=stream_exact)

    ivf_s = search.make("ivf")
    flat_s = search.make("flat_adc")
    for depth in depths:
        name = "pq" if depth == 1 else f"rq{depth}"
        cfg = search.SearchConfig(
            num_lists=lists, subspaces=subspaces, codewords=codewords,
            depth=depth, block_size=128, nprobe=8,
            train_size=min(n, 16384))
        t0 = time.perf_counter()
        ivf_state = ivf_s.build(_device.generator(3, dev), X, R, cfg,
                                device=dev)
        flat_state = flat_s.attach(ivf_state.index)
        index = ivf_state.index
        st = flat_s.stats(flat_state)
        # residual distortion on a held sample: the strict quantization
        # metric behind the recall frontier (recall can saturate)
        XRs = X[:4096] @ index.R
        res_s = XRs - index.centroids[index.coarse.assign(XRs).long()]
        sample_distortion = float(index.quantizer.distortion(res_s))
        out("build", scheme=name, n=n, lists=lists, subspaces=subspaces,
            codewords=codewords, depth=depth, capacity=st["capacity"],
            code_bytes_per_row=st["code_bytes_per_row"],
            compression=st["compression"],
            residual_distortion=sample_distortion,
            max_list_blocks=ivf_state.max_blocks,
            seconds=time.perf_counter() - t0)

        flat_ids = flat_s.search(flat_state, Q, k=10).ids
        flat_dt = _bench(lambda: flat_s.search(flat_state, Q, k=10), dev)
        flat_scan = st["capacity"]
        r_flat_exact = recall_at_k(flat_ids, exact_ids)
        out("row", backend="flat_adc", scheme=name, scan_rows=flat_scan,
            qps=queries / flat_dt, recall10_vs_exact=r_flat_exact)
        swept.add("flat_adc")

        # int8 tables over the same index: recall within 0.01 of float32's
        flat8_state = flat_s.attach(index, lut_dtype="int8")
        flat8_ids = flat_s.search(flat8_state, Q, k=10).ids
        flat8_dt = _bench(lambda: flat_s.search(flat8_state, Q, k=10), dev)
        r_flat8 = recall_at_k(flat8_ids, exact_ids)
        out("row", backend="flat_adc[int8]", scheme=name,
            scan_rows=flat_scan, qps=queries / flat8_dt,
            recall10_vs_exact=r_flat8)
        checks[f"{name}_int8_recall_within_0.01"] = (
            r_flat8 >= r_flat_exact - 0.01)

        rows = []
        passed = False
        for nprobe in (1, 2, 4, 8, 16, 32, 64):
            if nprobe > lists:
                break
            res = ivf_s.search(ivf_state, Q, k=10, nprobe=nprobe)
            dt = _bench(lambda p=nprobe: ivf_s.search(ivf_state, Q, k=10,
                                                      nprobe=p), dev)
            scan = float(res.scanned.float().mean())
            reduction = flat_scan / max(scan, 1.0)
            r_flat = recall_at_k(res.ids, flat_ids)
            r_exact = recall_at_k(res.ids, exact_ids)
            rows.append(dict(nprobe=nprobe, scan=scan, reduction=reduction,
                             qps=queries / dt, recall_flat=r_flat,
                             recall_exact=r_exact))
            out("row", backend="ivf", scheme=name, **rows[-1])
            if r_flat >= 0.9 and reduction >= 5.0:
                passed = True
        swept.add("ivf")

        # the refresh through the protocol: the delta a trainer would emit
        Rp = index.R.clone().requires_grad_(True)
        (G,) = torch.autograd.grad(
            index.quantizer.distortion(X[:8192] @ Rp), Rp)
        learner = rotations.make("subspace_gcd", sub=index.quantizer.sub)
        _, delta = learner.update(learner.init_from(index.R), G, 2e-3)
        refreshed = ivf_s.refresh(ivf_state, delta)
        mismatch = float(maintain.refresh_mismatch(refreshed.index, X))
        post = ivf_s.search(refreshed, Q, k=10, nprobe=min(32, lists))
        post_recall = recall_at_k(post.ids, exact_ids)
        out("refresh", scheme=name, code_mismatch=mismatch,
            post_refresh_recall10_vs_exact=post_recall)

        results[name] = dict(rows=rows, flat_recall_exact=r_flat_exact,
                             int8_recall_exact=r_flat8,
                             compression=st["compression"],
                             refresh_mismatch=mismatch,
                             post_refresh_recall=post_recall,
                             residual_distortion=sample_distortion)
        full_probe_recall[name] = (r_flat_exact, sample_distortion)
        if depth == 1:
            checks["pq_scan_reduction_at_recall"] = passed

            # the Engine over ragged batches: one executable a bucket
            engine = search.Engine(ivf_s, ivf_state, k=10, nprobe=8,
                                   min_bucket=32)
            sizes = (31, 60, 17, 31, queries)
            for sz in sizes:
                engine.search(Q[:sz])
            es = engine.stats()
            buckets = {engine._bucket(sz) for sz in sizes}
            checks["engine_compile_cache"] = (
                es["compiles"] <= len(buckets)
                and es["executables"] <= len(buckets))
            results["engine"] = dict(
                compiles=es["compiles"], executables=es["executables"],
                requests=es["requests"], lut_hit_rate=es["lut_hit_rate"],
                latency_ms_p50=es["latency_ms_p50"])
            out("engine", buckets=sorted(buckets), **results["engine"])

            # the fused-refresh Engine: the delta goes to the query side,
            # so the refresh makes no executable and drops no table
            fstate = flat_s.attach(index, lut_dtype="int8",
                                   fused_refresh=True)
            feng = search.Engine(flat_s, fstate, k=10, min_bucket=32)
            feng.search(Q)
            fc0 = feng.stats()["executables"]
            feng.refresh(delta)
            post_f = feng.search(Q)
            fs = feng.stats()
            fr = recall_at_k(post_f.ids, exact_ids)
            checks["fused_refresh_no_recompile"] = fs["executables"] == fc0
            checks["fused_refresh_no_lut_invalidation"] = (
                fs["lut_invalidations"] == 0 and fs["lut_epoch"] == 0)
            results["fused_engine"] = dict(
                executables=fs["executables"],
                lut_invalidations=fs["lut_invalidations"],
                lut_hits=fs["lut_hits"], post_refresh_recall=fr)
            out("fused_engine", **results["fused_engine"])
        else:
            # RQ end to end: built, searched, refreshed; the refresh stays
            # exact (within-subspace pairs) and recall survives it
            checks[f"{name}_end_to_end"] = (
                mismatch <= 0.01 and post_recall == post_recall
                and post_recall > 0.0)

        if depth == depths[0]:
            # the sharded twins over the same artifacts: recall against the
            # replicated twin row for row (every registry name swept at
            # the first depth)
            S = len(mesh.devices)
            ivf8_ids = ivf_s.search(ivf_state, Q, k=10, nprobe=8).ids
            sharded_ok = True
            for sh_name, want_ids in (("exact_sharded", exact_ids),
                                      ("flat_sharded", flat_ids),
                                      ("ivf_sharded", ivf8_ids)):
                sh_s = search.make(sh_name, mesh=mesh)
                if sh_name == "exact_sharded":
                    sh_state = sh_s.build(None, X, R, search.SearchConfig(
                        tile_rows=8192))
                else:
                    sh_state = sh_s.attach(index, mesh=mesh, nprobe=8)
                kw = {"nprobe": 8} if sh_name == "ivf_sharded" else {}
                res = sh_s.search(sh_state, Q, k=10, **kw)
                dt = _bench(lambda s_=sh_s, st_=sh_state, kw_=kw: s_.search(
                    st_, Q, k=10, **kw_), dev)
                r_twin = recall_at_k(res.ids, want_ids)
                sharded_ok &= r_twin >= 0.999
                out("row", backend=sh_name, scheme=name, shards=S,
                    scan_rows_per_shard=float(res.scanned.float().mean()) / S,
                    qps=queries / dt, recall10_vs_exact=recall_at_k(
                        res.ids, exact_ids), recall10_vs_twin=r_twin)
                swept.add(sh_name)
            checks["sharded_parity"] = bool(sharded_ok)

    if 1 in depths and len(full_probe_recall) > 1:
        pq_r, pq_d = full_probe_recall["pq"]
        best_rq = max(v[0] for k, v in full_probe_recall.items() if k != "pq")
        best_rq_d = min(v[1] for k, v in full_probe_recall.items()
                        if k != "pq")
        # more code bits a row must buy strictly lower residual distortion
        # without losing end-to-end recall
        checks["rq_beats_pq_quantization"] = (
            best_rq_d < pq_d and best_rq >= pq_r - 1e-6)
        out("frontier", pq_flat_recall=pq_r, best_rq_flat_recall=best_rq,
            pq_distortion=pq_d, best_rq_distortion=best_rq_d)

    if devices > 1:
        cfg = search.SearchConfig(
            num_lists=lists, subspaces=subspaces, codewords=codewords,
            nprobe=8, train_size=min(n, 16384))
        cell = sharded_cell(X, Q, R, cfg, mesh, exact_ids)
        results["sharded"] = cell
        out("sharded_cell", **cell)
        # near linear: a shard's scan within 2× of the ideal 1/S slice
        # (block padding rounds short per-shard lists up to whole tiles)
        checks["sharded_scan_linear"] = (
            cell["reduction_per_device"] >= devices / 2.0)
        checks["sharded_recall_unchanged"] = (
            cell["recall_sharded"] >= cell["recall_single"] - 1e-6
            and cell["parity"])
        checks["sharded_refresh_no_recompile"] = (
            cell["refresh_recompiles"] == 0)

    checks["registry_swept"] = swept == set(search.names())
    out("checks", passed=all(checks.values()), **checks)
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--lists", type=int, default=256)
    ap.add_argument("--subspaces", type=int, default=16)
    ap.add_argument("--codewords", type=int, default=256)
    ap.add_argument("--depths", default="1,2",
                    help="comma list of residual depths (1 = PQ, 2 = RQ-2)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the sharded twins and cell")
    ap.add_argument("--shard-device", default=None,
                    help="where the shards go: one device for all (cuda:0, "
                    "cpu) or a comma list of one a shard")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, checks = run(n=args.n, dim=args.dim, queries=args.queries,
                    lists=args.lists, subspaces=args.subspaces,
                    codewords=args.codewords,
                    depths=tuple(int(d) for d in args.depths.split(",")),
                    devices=args.devices, device=dev,
                    shard_device=args.shard_device)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
