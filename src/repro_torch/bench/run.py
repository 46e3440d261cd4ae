"""Benchmark entry point of the port (port of ``benchmarks/run.py``):
``PYTHONPATH=src python -m repro_torch.bench.run [--fast] [--only serve]``.

One section a paper table or figure, run through the port's
``repro_torch.bench`` scripts in the JAX order (``train_e2e`` first) at
the JAX script's ``--fast`` and full sizes, each on ``--device`` (the card
unless ``--device cpu``). Each section's checks are booked as
``section/check``; the run exits 1 when one fails. Every section's
results and checks go into one ``BENCH_<name>.json`` run record through
``obs.write_bench``.

Departures from the JAX script:

  * **It never writes under ``benchmarks/``.** The destination is ``--out``
    or ``$REPRO_BENCH_DIR``; without either it writes nothing. (The JAX
    ``--fast`` falls back to the tracked ``benchmarks/`` directory.)
  * **Its trajectories are ``torch_fast`` and ``torch_full``**
    (``serve_load``'s own is ``torch_serve``), so a shared
    ``$REPRO_BENCH_DIR`` never mixes a card run into a JAX trajectory.
  * **``kernels`` times the hand-written kernels** (``bench.kernels_micro``:
    each kernel's device time beside its plain version's and the port's
    roofline prediction) and **``roofline`` reads the port's dry-run
    records** (``launch.dryrun --out DIR``) from ``--dryrun-dir``; without
    it the section books no cell.
  * **``--devices N`` shards in one process.** The ``ivf`` and ``churn``
    sections add their sharded cells over N shards, one a visible card;
    with fewer cards the run raises unless ``--shard-device`` names where
    the shards go (``cuda:0`` lays all N on one card). The JAX script
    forces N host devices in a subprocess instead.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import device as _device
from repro_torch.bench import common

SECTIONS = ("train_e2e", "fig2a", "fig2bc", "table1", "fig4", "ivf",
            "churn", "serve", "kernels", "roofline")


def resolve_bench_dir(cli_out: str | None) -> str | None:
    """--out, else $REPRO_BENCH_DIR, else None (print only)."""
    return cli_out or os.environ.get("REPRO_BENCH_DIR") or None


def sections_of(only: str | None) -> list[str]:
    """The sections to run, in the JAX order; raises for a section that is
    not known."""
    if not only:
        return list(SECTIONS)
    names = [s for s in only.split(",") if s]
    for s in names:
        if s not in SECTIONS:
            raise ValueError(f"unknown section {s!r}; have {SECTIONS}")
    return [s for s in SECTIONS if s in names]


def run_sections(names, *, fast: bool, device,
                 dryrun_dir: str | None = None, devices: int = 1,
                 shard_device=None) -> tuple[dict, dict, list]:
    """Run ``names`` at the JAX script's sizes; (sections, checks,
    failures) with every check under ``section/check``. ``devices`` > 1
    adds the ivf and churn sections' sharded cells over
    ``common.shard_mesh(devices, shard_device, device)``."""
    sharded = dict(devices=devices, shard_device=shard_device)
    sections: dict = {}
    checks_all: dict = {}
    failures: list = []

    def book(name: str, results, checks: dict | None = None) -> None:
        sections[name] = results
        for k, v in (checks or {}).items():
            key = f"{name}/{k}"
            checks_all[key] = bool(v)
            if not v:
                failures.append(key)

    if "train_e2e" in names:
        # first: the p99 checks compare an off-thread pass with an inline
        # one, and a heap warmed by other sections skews the two arms
        from repro_torch.bench import train_e2e
        if fast:
            res, checks = train_e2e.run(
                n=32000, dim=32, queries=64, lists=32, subspaces=8,
                codewords=32, steps=54, batch=8192, nprobe=8,
                refresh_every=6, compact_every=3, reencode_rows=2048,
                staging_rows=512, churn_batch=32, churn_every=3,
                warmup=12, probe_every=6, device=device)
        else:
            res, checks = train_e2e.run(device=device)
        book("train_e2e", res, checks)

    if "fig2a" in names:
        from repro_torch.bench import fig2a_convergence
        res, checks = fig2a_convergence.run(
            num=2048 if fast else 4096, iters=15 if fast else 25,
            device=device)
        book("fig2a", res, checks)

    if "fig2bc" in names:
        from repro_torch.bench import fig2bc_stability
        out, stable = fig2bc_stability.run(
            num=2048 if fast else 4096, runs=3 if fast else 5,
            iters=12 if fast else 20, device=device)
        book("fig2bc", out, {"stability": stable})

    if "table1" in names:
        from repro_torch.bench import fig3_table1_e2e
        res, checks = fig3_table1_e2e.run(
            steps=60 if fast else 250, warmup=30 if fast else 40,
            device=device)
        book("table1", res, checks)

    if "fig4" in names:
        from repro_torch.bench import fig4_runtime
        out, checks = fig4_runtime.run(
            dims=(64, 128, 256) if fast else (64, 128, 256, 512),
            device=device)
        book("fig4", out, checks)

    if "ivf" in names:
        from repro_torch.bench import ivf_recall_qps
        res, checks = ivf_recall_qps.run(
            n=20_000 if fast else 100_000, queries=64 if fast else 256,
            lists=64 if fast else 256, depths=(1, 2), device=device,
            **sharded)
        book("ivf", res, checks)

    if "churn" in names:
        from repro_torch.bench import churn as churn_bench
        if fast:
            res, checks = churn_bench.run(
                n=8000, dim=32, queries=64, lists=32, subspaces=8,
                codewords=32, steps=6, batch=64, nprobe=8,
                staging_rows=512, device=device, **sharded)
        else:
            res, checks = churn_bench.run(device=device, **sharded)
        book("churn", res, checks)

    if "serve" in names:
        from repro_torch.bench import serve_load
        if fast:
            res, checks = serve_load.run(**serve_load.FAST, device=device)
        else:
            res, checks = serve_load.run(device=device)
        book("serve", res, checks)

    if "kernels" in names:
        from repro_torch.bench import kernels_micro
        results = kernels_micro.run(device=device)
        book("kernels", results, {k: v["ok"] for k, v in results.items()})

    if "roofline" in names:
        from repro_torch.bench import roofline_table
        book("roofline", roofline_table.run(dryrun_dir=dryrun_dir))
    return sections, checks_all, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(SECTIONS))
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the ivf and churn sections' sharded "
                    "cells (1: none)")
    ap.add_argument("--shard-device", default=None,
                    help="where the shards go: one device for all (cuda:0, "
                    "cpu) or a comma list of one a shard")
    ap.add_argument("--out", default=None,
                    help="BENCH_torch_*.json destination dir (default "
                         "$REPRO_BENCH_DIR; unset: print only)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dryrun-dir", default=None,
                    help="the roofline section's records (launch.dryrun "
                         "--out); default none")
    args = ap.parse_args(argv)
    names = sections_of(args.only)
    dev = _device.resolve(args.device)
    common.shard_mesh(args.devices, args.shard_device, dev)  # raises early
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    sections, checks, failures = run_sections(names, fast=args.fast,
                                              device=dev,
                                              dryrun_dir=args.dryrun_dir,
                                              devices=args.devices,
                                              shard_device=args.shard_device)
    elapsed = time.time() - t0
    common.emit("run", "total", seconds=elapsed, sections=names,
                failures=failures)

    out_dir = resolve_bench_dir(args.out)
    if out_dir and sections:
        from repro_torch import obs

        name = "torch_fast" if args.fast else "torch_full"
        path = obs.write_bench(
            out_dir, name, sections=sections, checks=checks,
            config=dict(only=names, fast=args.fast, devices=args.devices,
                        shard_device=args.shard_device, device=dev.type,
                        elapsed_s=elapsed))
        errs = obs.validate_bench(path)
        common.emit("run", "bench", path=path, valid=not errs, errors=errs)
        if errs:
            return 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
