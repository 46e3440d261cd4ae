"""BENCH_*.json — the benchmark trajectory (port of ``repro/obs/bench.py``;
the same schema and CLI).

Each benchmark run appends one structured run record to
``BENCH_<name>.json``, so numbers land against a recorded history instead
of scrolling past.

Schema (``repro.bench/v1``, shared with the JAX package: a file written by
either validates under the other's ``validate_bench``)::

    {
      "schema": "repro.bench/v1",
      "name": "torch_fast",                # trajectory name
      "runs": [                            # append-only, oldest first
        {
          "created": "2026-10-18T12:00:00+00:00",   # ISO-8601 UTC
          "host": {"backend": "cuda", "device_count": 1,
                   "torch": "2.11.0+cu128", "cuda": "12.8",
                   "device": "NVIDIA H100 80GB HBM3",
                   "power_limit": "700.00 W", "python": "3.12.3"},
          "config": {...},                 # the run's knobs
          "sections": {"serve": {...}, ...},
          "checks": {"serve/zero_steady_state_recompiles": true, ...}
        }
      ]
    }

``sections`` holds each benchmark's results; ``checks`` is the flat map of
claim checks, every value a bool, so the file is also a pass/fail record.
Non-finite floats are written as null: a NaN never passes for a measured
number. ``host`` names the card a run's numbers come from (its name and
``nvidia-smi`` power limit) when torch sees one.

CLI::

    python -m repro_torch.obs.bench --validate BENCH_torch_fast.json
    python -m repro_torch.obs.bench --show BENCH_torch_fast.json
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile

import torch

from repro_torch.obs.export import jsonable

SCHEMA = "repro.bench/v1"


def _power_limit() -> str | None:
    """The first card's power limit as ``nvidia-smi`` gives it, or None
    without the tool."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.strip().splitlines()[0] if out.strip() else ""
    return line.rsplit(",", 1)[-1].strip() if "," in line else None


def host_info() -> dict:
    """Where the run's numbers come from: ``backend`` "cuda" when torch sees
    a card (as the JAX package records its default backend), else "cpu"."""
    cuda = torch.cuda.is_available()
    info = dict(
        backend="cuda" if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 1,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=platform.python_version(),
    )
    if cuda:
        info.update(device=torch.cuda.get_device_name(0),
                    power_limit=_power_limit())
    return info


def make_run(sections: dict, checks: dict, config: dict | None = None) -> dict:
    """One schema-valid run record (UTC timestamp, payloads made
    JSON-safe)."""
    return dict(
        created=datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        host=host_info(),
        config=jsonable(config or {}),
        sections={str(k): jsonable(v) for k, v in sections.items()},
        checks={str(k): bool(v) for k, v in checks.items()},
    )


def bench_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"BENCH_{name}.json")


def load_bench(path: str) -> dict:
    """Strict load: a bare NaN or Infinity is a schema violation."""
    def _reject(tok):
        raise ValueError(f"non-finite literal {tok!r} in {path}")

    with open(path, encoding="utf-8") as fh:
        return json.load(fh, parse_constant=_reject)


def write_bench(out_dir: str, name: str, sections: dict, checks: dict,
                config: dict | None = None) -> str:
    """Append one run to the ``BENCH_<name>.json`` trajectory (made on the
    first write). Atomic: a temporary file, then a rename, so a crash
    leaves no truncated trajectory; a corrupt or invalid one starts
    afresh."""
    os.makedirs(out_dir, exist_ok=True)
    path = bench_path(out_dir, name)
    doc = {"schema": SCHEMA, "name": name, "runs": []}
    if os.path.exists(path):
        try:
            prev = load_bench(path)
            if not validate_bench(prev):
                doc = prev
        except ValueError:       # json.JSONDecodeError is a ValueError
            pass
    doc["runs"].append(make_run(sections, checks, config))
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    with os.fdopen(fd, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, allow_nan=False)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def validate_bench(doc_or_path) -> list[str]:
    """The schema check: the list of violations ([] when valid)."""
    if isinstance(doc_or_path, str):
        try:
            doc = load_bench(doc_or_path)
        except (OSError, ValueError) as e:
            return [f"unreadable: {e}"]
    else:
        doc = doc_or_path

    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema") != SCHEMA:
        errs.append(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("name"), str) or not doc.get("name"):
        errs.append("name must be a non-empty string")
    runs = doc.get("runs")
    if not isinstance(runs, list) or not runs:
        return errs + ["runs must be a non-empty list"]
    for i, run in enumerate(runs):
        where = f"runs[{i}]"
        if not isinstance(run, dict):
            errs.append(f"{where} is not an object")
            continue
        if not isinstance(run.get("created"), str):
            errs.append(f"{where}.created must be an ISO timestamp string")
        host = run.get("host")
        if not isinstance(host, dict) or "backend" not in host \
                or "device_count" not in host:
            errs.append(f"{where}.host must carry backend + device_count")
        sections = run.get("sections")
        if not isinstance(sections, dict) or not sections:
            errs.append(f"{where}.sections must be a non-empty object")
        checks = run.get("checks")
        if not isinstance(checks, dict):
            errs.append(f"{where}.checks must be an object")
        else:
            for k, v in checks.items():
                if not isinstance(v, bool):
                    errs.append(
                        f"{where}.checks[{k!r}] must be a bool, got "
                        f"{type(v).__name__}")
        try:
            json.dumps(run, allow_nan=False)
        except (TypeError, ValueError) as e:
            errs.append(f"{where} not strictly JSON-serializable: {e}")
    return errs


def _numeric_leaves(obj, prefix="") -> dict[str, float]:
    """Nested dicts flattened to dot-path → float (bools left out: they
    belong to ``checks``)."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_numeric_leaves(v, f"{prefix}{k}."))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    return out


def section_deltas(prev: dict, last: dict) -> dict[str, list[tuple]]:
    """Per-section numeric deltas between two run records: section →
    [(leaf, old, new, pct_change)] over the leaves both carry."""
    out: dict[str, list[tuple]] = {}
    for sec, payload in last.get("sections", {}).items():
        a = _numeric_leaves(prev.get("sections", {}).get(sec, {}))
        b = _numeric_leaves(payload)
        rows = []
        for leaf in sorted(set(a) & set(b)):
            old, new = a[leaf], b[leaf]
            pct = ((new - old) / abs(old) * 100.0) if old else float("inf")
            rows.append((leaf, old, new, pct))
        if rows:
            out[sec] = rows
    return out


def show(path: str) -> str:
    """A compact view: one line a run (date, backend, checks), then the
    latest run's per-section delta against the one before, every numeric
    leaf both carry, old → new with the change in percent."""
    doc = load_bench(path)
    lines = [f"{path}: trajectory {doc['name']!r}, {len(doc['runs'])} run(s)"]
    for run in doc["runs"]:
        checks = run.get("checks", {})
        bad = [k for k, v in checks.items() if not v]
        status = "PASS" if not bad else f"FAIL({','.join(bad)})"
        lines.append(
            f"  {run.get('created', '?'):<26} "
            f"{run.get('host', {}).get('backend', '?'):<5} "
            f"sections={sorted(run.get('sections', {}))} "
            f"checks={len(checks)} {status}")
    if len(doc["runs"]) >= 2:
        prev, last = doc["runs"][-2], doc["runs"][-1]
        lines.append(f"  delta: {last.get('created', '?')} vs "
                     f"{prev.get('created', '?')}")
        for sec, rows in section_deltas(prev, last).items():
            lines.append(f"    [{sec}]")
            for leaf, old, new, pct in rows:
                lines.append(f"      {leaf:<52} {old:>14.4g} -> "
                             f"{new:>14.4g}  ({pct:+.1f}%)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate / inspect BENCH_*.json trajectory files")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check each file; non-zero exit on violation")
    ap.add_argument("--show", action="store_true",
                    help="print a one-line-per-run trajectory summary")
    args = ap.parse_args(argv)

    rc = 0
    for path in args.paths:
        if args.show:
            print(show(path))
        errs = validate_bench(path)
        if errs:
            rc = 1
            for e in errs:
                print(f"{path}: INVALID: {e}")
        elif args.validate:
            doc = load_bench(path)
            print(f"{path}: valid ({len(doc['runs'])} run(s))")
    return rc


if __name__ == "__main__":
    sys.exit(main())
