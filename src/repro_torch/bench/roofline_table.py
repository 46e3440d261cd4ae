"""The roofline table of the port's dry-run records (port of
``benchmarks/roofline_table.py``):
``PYTHONPATH=src python -m repro_torch.bench.roofline_table --dryrun-dir DIR``.

Reads the ``<arch>__<shape>__<mesh>.json`` records that
``launch.dryrun --out DIR`` wrote (either package's records: the keys are
the JAX record's) and renders one markdown row a cell: FLOPs, the three
roofline terms, the dominant one, the useful-compute ratio, the peak and
whether it fits, with the port's ``step_s``, ``measured_at`` and
``reduced`` where a record has them. There is no default directory: the
port writes no records under ``experiments/`` or ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.bench import common


def load(dryrun_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _num(x, fmt: str) -> str:
    return "—" if x is None else format(x, fmt)


def _measured(r: dict) -> str:
    pts = r.get("measured_at") or []
    if not pts:
        return "reckoned"
    return "; ".join(
        f"d{p['depth'] if p['depth'] is not None else '='}"
        f" b{p['batch']}" + (f" a{p['accum']}" if p.get("accum", 1) > 1
                             else "") for p in pts)


def markdown_table(dryrun_dir: str, mesh: str | None = None) -> str:
    """One row a record (of ``mesh`` only, when given)."""
    recs = [r for r in load(dryrun_dir) if mesh is None or r["mesh"] == mesh]
    lines = [
        "| arch | shape | mesh | fits | measured at | peak GB | step s |"
        " FLOPs/dev | compute s | memory s | dominant | useful ratio |"
        " cuts |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
                         f" FAILED: {r.get('error', '?')[:60]} |"
                         + " |" * 9)
            continue
        rep = r["report"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {'yes' if r.get('fits_hbm') else 'NO'} | {_measured(r)} |"
            f" {rep['memory']['peak_bytes'] / 1e9:.2f} |"
            f" {_num(r.get('step_s'), '.4g')} |"
            f" {rep['flops_per_device']:.3e} | {rep['compute_s']:.3e} |"
            f" {rep['memory_s']:.3e} | {rep['dominant']} |"
            f" {_num(rep.get('useful_compute_ratio'), '.3f')} |"
            f" {'; '.join(r.get('reduced') or []) or '—'} |")
    return "\n".join(lines)


def run(verbose: bool = True, dryrun_dir: str | None = None) -> dict:
    """The records of ``dryrun_dir`` (none without it): a line a record
    and the table, as the ``roofline`` section of ``bench.run`` books
    them."""
    recs = load(dryrun_dir) if dryrun_dir else []
    ok = [r for r in recs if r.get("ok")]
    if verbose:
        for r in ok:
            rep = r["report"]
            common.emit("roofline", f"{r['arch']}/{r['shape']}/{r['mesh']}",
                        compute_s=rep["compute_s"], memory_s=rep["memory_s"],
                        collective_s=rep["collective_s"],
                        dominant=rep["dominant"],
                        fraction=rep["roofline_fraction"],
                        peak_gb=rep["memory"]["peak_bytes"] / 1e9,
                        step_s=r.get("step_s"), fits=r.get("fits_hbm"))
        common.emit("roofline", "summary", dryrun_dir=dryrun_dir,
                    cells_ok=len(ok), cells_failed=len(recs) - len(ok))
    return dict(dryrun_dir=dryrun_dir, cells_ok=len(ok),
                cells_failed=len(recs) - len(ok),
                table=markdown_table(dryrun_dir) if dryrun_dir else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default=None,
                    help="the records of launch.dryrun --out")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    if not args.dryrun_dir:
        ap.error("--dryrun-dir: the records of launch.dryrun --out")
    print(markdown_table(args.dryrun_dir, args.mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
