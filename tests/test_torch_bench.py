"""The port's BENCH trajectory writer (``repro_torch.obs.bench``), its
``bench.serve_load`` and its ``bench.run`` on the CPU, held against the
JAX package's.

A file written by either package validates under the other's
``validate_bench``; the committed ``benchmarks/BENCH_fast.json`` validates
under the port's and is only read. ``serve_load.run`` at a tiny size has
the JAX run's result keys and holds the five checks that are not timing
claims; its arrival trace is the JAX script's. ``bench.run`` never writes
under ``benchmarks/`` and raises for the sharded cells; its ``kernels``
section holds each kernel's plain version at the JAX script's shapes and
its ``roofline`` section renders the dry run's records.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import bench as jbench
from repro_torch import obs
from repro_torch.bench import run as brun
from repro_torch.bench import serve_load
from repro_torch.obs import bench

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))           # the JAX benchmarks package

TIMING = "adaptive_beats_best_fixed_p99_at_equal_recall"
#: load 3: the rate is calibrated from warm-up times that a busy CPU (other
#: test workers) can inflate; at 1.1 a cell may then see no backlog, and
#: adaptive_sheds_under_load, a check of the shedding under load, no load
TINY = dict(n=1500, dim=16, lists=8, subspaces=4, codewords=16, ladder=(2, 4),
            requests=120, max_admit=8, refresh_every=50, load=3.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tiny shapes: the suite runs in
    several worker processes on one machine, and a thread a core in each
    slows these searches a hundredfold (measured: a bucket-8 search 2–3 ms
    alone, 350–800 ms with six workers), past the latency budgets the SLO
    tests serve under."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _doc(path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def test_exports_carry_the_jax_names():
    for name in ("BENCH_SCHEMA", "bench_path", "load_bench",
                 "validate_bench", "write_bench"):
        assert hasattr(obs, name) and hasattr(jobs, name)
    assert obs.BENCH_SCHEMA == jobs.BENCH_SCHEMA == "repro.bench/v1"
    assert obs.bench_path("d", "x") == jobs.bench_path("d", "x")


def test_each_package_validates_the_others_file(tmp_path):
    sections = {"serve": {"p99_ms": 3.5, "cells": {"a": [1, 2]}}}
    checks = {"serve/zero_steady_state_recompiles": True}
    tp = obs.write_bench(str(tmp_path / "t"), "torch_fast", sections,
                         checks, config={"fast": True})
    jp = jobs.write_bench(str(tmp_path / "j"), "fast", sections, checks,
                          config={"fast": True})
    assert jobs.validate_bench(tp) == [] and obs.validate_bench(tp) == []
    assert obs.validate_bench(jp) == [] and jobs.validate_bench(jp) == []
    host = _doc(tp)["runs"][0]["host"]
    assert host["backend"] == "cpu" and host["device_count"] == 1
    assert host["torch"] and "jax" not in host
    # a second write appends to the trajectory
    obs.write_bench(str(tmp_path / "t"), "torch_fast", sections, checks)
    assert len(obs.load_bench(tp)["runs"]) == 2


def test_committed_bench_fast_validates_read_only():
    path = ROOT / "benchmarks" / "BENCH_fast.json"
    before = path.read_bytes()
    assert obs.validate_bench(str(path)) == []
    assert path.read_bytes() == before


def test_non_finite_values_become_null_and_bare_nan_is_invalid(tmp_path):
    p = obs.write_bench(str(tmp_path), "x",
                        {"s": {"a": float("nan"), "b": np.float32("inf"),
                               "c": np.arange(3)}},
                        {"ok": np.bool_(True)})
    run = obs.load_bench(p)["runs"][0]
    assert run["sections"]["s"] == {"a": None, "b": None, "c": [0, 1, 2]}
    assert run["checks"] == {"ok": True}
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(Path(p).read_text().replace('"a": null', '"a": NaN'))
    for validate in (obs.validate_bench, jobs.validate_bench):
        errs = validate(str(bad))
        assert errs and errs[0].startswith("unreadable")
    assert obs.validate_bench({"schema": "repro.bench/v1", "name": "x",
                               "runs": [{"created": "t", "host": {},
                                         "sections": {}, "checks": {
                                             "c": 1}}]}) == \
        jobs.validate_bench({"schema": "repro.bench/v1", "name": "x",
                             "runs": [{"created": "t", "host": {},
                                       "sections": {}, "checks": {"c": 1}}]})


def test_corrupt_trajectory_starts_fresh(tmp_path):
    path = Path(obs.bench_path(str(tmp_path), "torch_fast"))
    path.write_text("{not json")
    obs.write_bench(str(tmp_path), "torch_fast", {"s": {"v": 1}}, {})
    doc = obs.load_bench(str(path))
    assert len(doc["runs"]) == 1 and obs.validate_bench(doc) == []
    assert not list(tmp_path.glob("*.tmp"))


def test_section_deltas_and_show_equal_jax(tmp_path):
    """One two-run document: the port's delta table and trajectory view
    are the JAX package's."""
    p = jobs.write_bench(str(tmp_path), "fast",
                         {"fig4": {"gcd": {"us": 10.0}, "n": 4}},
                         {"fig4/ok": True})
    jobs.write_bench(str(tmp_path), "fast",
                     {"fig4": {"gcd": {"us": 12.5}, "n": 4, "new": 1.0},
                      "serve": {"p99": 3.0}},
                     {"fig4/ok": False})
    doc = jobs.load_bench(p)
    prev, last = doc["runs"]
    assert bench.section_deltas(prev, last) == \
        jbench.section_deltas(prev, last)
    assert bench.section_deltas(prev, last)["fig4"][0] == (
        "gcd.us", 10.0, 12.5, 25.0)
    assert bench.show(p) == jbench.show(p)
    assert bench.main(["--validate", "--show", p]) == 0


def test_arrival_trace_equals_jax():
    from benchmarks import serve_load as jload

    for rate in (250.0, 3.3e4):
        want = jload._arrival_trace(np.random.default_rng(42), requests=500,
                                    rate_qps=rate, pool_size=64)
        got = serve_load._arrival_trace(np.random.default_rng(42),
                                        requests=500, rate_qps=rate,
                                        pool_size=64)
        assert got == want


def test_serve_load_run_has_the_jax_keys_and_holds_its_checks():
    """The port's run at a tiny size on the CPU against the JAX run at the
    same size: the same result keys (and cell keys), and the five checks
    that are not timing claims hold."""
    from benchmarks import serve_load as jload

    jres, jchecks = jload.run(verbose=False, **TINY)
    res, checks = serve_load.run(verbose=False, device="cpu", **TINY)
    assert set(jres) <= set(res)
    for cell in jres["cells"]:
        assert set(jres["cells"][cell]) <= set(res["cells"][cell])
    assert set(checks) == set(jchecks)
    assert {k: v for k, v in checks.items() if k != TIMING} == {
        k: True for k in checks if k != TIMING}
    assert res["ladder"] == jres["ladder"] == [2, 4]
    assert res["requests"] == jres["requests"] == TINY["requests"]
    a = res["cells"]["adaptive"]
    assert a["alpha_refreshes"] == TINY["requests"] // TINY["refresh_every"]
    assert set(a["rung_mix"]) <= {"2", "4"}
    assert set(a["ewma_ms"]["alpha"]) == {"b8/np2", "b8/np4"}


def test_run_destination_never_falls_back_to_benchmarks(monkeypatch,
                                                         tmp_path):
    monkeypatch.delenv("REPRO_BENCH_DIR", raising=False)
    assert brun.resolve_bench_dir(None) is None
    assert brun.resolve_bench_dir(str(tmp_path)) == str(tmp_path)
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path / "env"))
    assert brun.resolve_bench_dir(None) == str(tmp_path / "env")
    assert brun.resolve_bench_dir("") == str(tmp_path / "env")


def test_run_raises_for_what_is_not_ported():
    # --devices N on the CPU needs the shards named; it never stacks them
    with pytest.raises(ValueError, match="--shard-device"):
        brun.main(["--devices", "2", "--only", "serve", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown section"):
        brun.sections_of("nope")
    assert brun.sections_of(None) == list(brun.SECTIONS)
    assert brun.sections_of("serve,fig4") == ["fig4", "serve"]


def test_run_kernels_section_on_cpu():
    """The JAX script's rows at its shapes, each held on the plain versions
    (the CPU runs no kernel) by the JAX script's checks."""
    sections, checks, failures = brun.run_sections(["kernels"], fast=True,
                                                   device=torch.device("cpu"))
    rows = sections["kernels"]
    assert set(rows) == {"givens_rotate", "gcd_score", "gcd_score_ref",
                         "pq_assign", "adc_lookup", "adc_lookup_int8",
                         "embedding_bag", "fused_lut", "stream_merge",
                         "fused_refresh"}
    assert failures == [] and all(checks.values())
    assert all(r["ok"] and r["us_per_call"] > 0 for r in rows.values())
    assert rows["adc_lookup_int8"]["bytes_ratio"] >= 2.0
    assert rows["adc_lookup_int8"]["topk_agree"] >= 0.9
    assert rows["fused_refresh"]["lut_invalidations"] == 0
    for name in ("givens_rotate", "gcd_score", "pq_assign", "adc_lookup",
                 "embedding_bag", "fused_lut"):
        assert rows[name]["predicted_us"] > 0, name


def test_run_roofline_section_reads_records(tmp_path, capsys):
    """Records that ``launch.dryrun.run_cell`` writes on the CPU, rendered
    into the roofline table by the ``roofline`` section."""
    from repro_torch.bench import roofline_table
    from repro_torch.launch import dryrun

    out = tmp_path / "dryrun"
    for aid, shape in (("wide-deep", "serve_p99"), ("olmo-1b", "long_500k")):
        assert dryrun.run_cell(aid, shape, device="cpu", out_dir=str(out),
                               verbose=False)["ok"]
    sections, _, failures = brun.run_sections(
        ["roofline"], fast=True, device=torch.device("cpu"),
        dryrun_dir=str(out))
    res = sections["roofline"]
    assert failures == [] and res["cells_ok"] == 2
    assert res["cells_failed"] == 0
    table = res["table"].splitlines()
    assert table[0].startswith("| arch | shape | mesh | fits |")
    assert len(table) == 4
    assert table[2].startswith("| olmo-1b | long_500k | 1xCPU | yes |")
    assert table[3].startswith("| wide-deep | serve_p99 | 1xCPU | yes |")
    assert brun.run_sections(["roofline"], fast=True,
                             device=torch.device("cpu"))[0]["roofline"][
        "cells_ok"] == 0
    assert roofline_table.main(["--dryrun-dir", str(out)]) == 0
    assert "| wide-deep | serve_p99 |" in capsys.readouterr().out


def test_run_writes_a_valid_torch_trajectory(monkeypatch, tmp_path):
    """One small section through bench.run: a torch_fast trajectory in the
    destination, valid under both packages; nothing written under
    benchmarks/ when no destination is given."""
    monkeypatch.setattr(serve_load, "FAST", dict(TINY))
    monkeypatch.delenv("REPRO_BENCH_DIR", raising=False)
    tracked = sorted(os.listdir(ROOT / "benchmarks"))
    rc = brun.main(["--fast", "--only", "serve", "--device", "cpu",
                    "--out", str(tmp_path)])
    path = tmp_path / "BENCH_torch_fast.json"
    doc = obs.load_bench(str(path))
    assert doc["name"] == "torch_fast" and len(doc["runs"]) == 1
    assert obs.validate_bench(str(path)) == []
    assert jobs.validate_bench(str(path)) == []
    run = doc["runs"][0]
    assert set(run["sections"]) == {"serve"}
    assert run["config"]["only"] == ["serve"]
    failed = [k for k, v in run["checks"].items() if not v]
    res = run["sections"]["serve"]
    adaptive = res["cells"]["adaptive"]
    assert set(failed) <= {f"serve/{TIMING}"}, (
        f"failed {failed}: the adaptive cell shed {adaptive['sheds']} and "
        f"ticked {adaptive['maintenance_ticks']} maintenance slots; top_ms "
        f"{res['top_ms']} (calibrations {res['top_ms_samples']}), rate "
        f"{res['rate_qps']} qps")
    assert rc == (1 if failed else 0)
    assert brun.main(["--fast", "--only", "serve", "--device", "cpu"]) \
        in (0, 1)
    assert sorted(os.listdir(ROOT / "benchmarks")) == tracked
