"""The general part of the benchmark: finds a cell's files by name, runs its
driver, reads the trace, and prints the result line.

A cell is ``workloads/<cell>.json``: its configuration's name, its
driver's name and the driver's traffic parameters. The configuration is
``configs/<config>.json``, the driver ``drivers/<driver>.py`` (a ``run``
function), and each per-layer metric ``metrics/<metric>.py`` (a ``read``
function). Which metrics a cell reports, and their units, come from
``BENCHMARK.json``. Adding a configuration, a cell or a metric adds files
and entries; nothing here changes.

A driver gets a ``Cell`` and returns a dict:

* ``attempted``, ``failed``: the units of work of the window (queries,
  steps) and those whose answer is missing or bad;
* ``e2e``: {end-to-end metric: value} taken by the host clock;
* ``host``, ``marks``, ``work``: what the per-layer readers read (host-clock
  series, the program's step marks in ms, the work counted by
  ``perfbench/work``).

It calls ``cell.window()`` around the measured loop, and ``cell.check``
for each number compared with the reference once the window has closed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: top-level modules the process must not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: entries of each list of the traced run's breakdown
TOP = 10


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> dict[str, str]:
    """{metric: unit} the cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return {m["name"]: m["unit"] for m in entries
            if cell in m.get("workloads", [cell])}


def forbidden_in(modules) -> list[str]:
    """The forbidden top-level names among module names, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names in ``sys.modules``."""
    return forbidden_in(list(sys.modules))


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


class Records:
    """What a per-layer reader reads: the device's activities in the traced
    window (name, start s, duration s), the window's length, and the
    driver's host-clock series, step marks and counted work."""

    def __init__(self, device_ops: list, window_s: float, host: dict,
                 marks: dict, work: dict):
        self.device_ops = device_ops
        self.window_s = window_s
        self.host = host
        self.marks = marks
        self.work = work

    @property
    def busy_s(self) -> float:
        return union_s([(s, s + d) for _, s, d in self.device_ops])

    def device_s(self, pattern: str = "") -> float:
        """Summed duration of the device activities whose name holds
        ``pattern``."""
        return sum(d for name, _, d in self.device_ops if pattern in name)


class Cell:
    """One run of one cell: its files' contents, the run's arguments, and
    the window and checks the driver reports through."""

    def __init__(self, name: str, wl: dict, cfg: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t_start: float):
        self.name = name
        self.workload = wl
        self.config = cfg
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.checks: dict[str, dict] = {}
        self.setup_s = None
        self.window_s = None
        self.memory_peak_bytes = 0
        self.prof = None

    def subseed(self, tag: str) -> int:
        """A 63-bit seed for one input, drawn from the run's seed."""
        ss = np.random.SeedSequence([self.seed, zlib.crc32(tag.encode())])
        return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))

    def numpy_seed(self, tag: str) -> int:
        return self.subseed(tag) % (2 ** 32)

    def generator(self, tag: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.subseed(tag))
        return g

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; the device is
        waited for, the profiler stopped and the run's peak memory (set-up
        and window) read where it ends. Yields the window's start on the
        host clock."""
        self.sync()
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        try:
            with torch.profiler.record_function("perfbench.window"):
                yield t0
                self.sync()
        finally:
            self.window_s = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                self.prof = prof
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with the reference, held to at most ``limit``."""
        self.checks[name] = dict(value=float(value), limit=float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values())

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])


def free() -> None:
    """Release the program's state before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _trace_records(cell: Cell, out: dict) -> tuple[Records, dict]:
    """Records and the breakdown from the traced window."""
    from torch.autograd import DeviceType

    events = cell.prof.events()
    win = [e for e in events if e.name == "perfbench.window"]
    lo = min(e.time_range.start for e in win) if win else 0.0
    hi = max(e.time_range.end for e in win) if win else float("inf")
    dev, cpu = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host range mirrored on the device's timeline is no activity
            if getattr(e, "is_user_annotation", False) or win and \
                    e.name == "perfbench.window":
                continue
            if b > lo and a < hi:
                a, b = max(a, lo), min(b, hi)
                dev.append((e.name, a * 1e-6, (b - a) * 1e-6))
        elif e.device_type == DeviceType.CPU and e.name != "perfbench.window":
            cpu.append((a, b, e.name))
    rec = Records(dev, (hi - lo) * 1e-6 if win else cell.window_s,
                  out.get("host", {}), out.get("marks", {}),
                  out.get("work", {}))
    by_name: dict[str, float] = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps([(s * 1e6, (s + d) * 1e6) for _, s, d in dev], lo, hi),
                  key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in idle:
        mid = 0.5 * (a + b)
        inside = [c for c in cpu if c[0] <= mid <= c[1]]
        what = max(inside, key=lambda c: c[0])[2] if inside else "python"
        named.append([f"host: {what}"[:200], (b - a) * 1e-6])
    brk = dict(device_ops=[[n[:200], s] for n, s in ops], idle_gaps=named)
    return rec, brk


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def run_cell(name: str, wl: dict, cfg: dict, bench: dict, seed: int,
             seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """Run one cell once; returns the result line's object."""
    cell = Cell(name, wl, cfg, seed, seconds, trace, device, t_start)
    driver = load_module("drivers", wl["driver"])
    out = driver.run(cell)
    wanted = cell_metrics(bench, name, trace)
    device_info: dict[str, Any] = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=cell.memory_peak_bytes)
    result: dict[str, Any] = dict(correct=cell.correct,
                                  attempted=int(out["attempted"]),
                                  failed=int(out["failed"]))
    metrics = {}
    if trace:
        rec, brk = _trace_records(cell, out)
        for metric, unit in wanted.items():
            value = load_module("metrics", metric).read(rec)
            if value is not None:
                metrics[metric] = dict(value=float(value), unit=unit)
        device_info.update(busy_s=rec.busy_s, window_s=rec.window_s)
        result.update(metrics=metrics, device=device_info, breakdown=brk)
    else:
        e2e = dict(out["e2e"], setup_s=cell.setup_s)
        metrics = {m: dict(value=float(e2e[m]), unit=u)
                   for m, u in wanted.items() if m in e2e}
        result.update(metrics=metrics, device=device_info)
    result["card"] = dict(power_limit=power_limit() if device.type == "cuda"
                          else None, **out.get("card", {}))
    result["checks"] = cell.checks
    return result
