"""The harness finds cells, configurations, drivers and metric readers by
name, picks up new ones from new files alone, and prints the contract's
result line."""
from __future__ import annotations

import json
import shutil

import pytest

from perfbench.tests import tiny
from perfbench import harness

BENCH = harness.benchmark()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (harness.REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        harness.config(wl["config"])
        driver = harness.load_module("drivers", wl["driver"])
        assert callable(driver.run) and callable(driver.control)
        assert set(wl["limits"]) >= {"bad_rows"} or len(wl["limits"]) == 3
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        for w in m["workloads"]:
            assert w in tiny.CELLS


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_result_line(name, trace):
    res = tiny.run(name, trace=trace)
    keys = list(res)
    assert keys[:5] == KEYS
    assert keys[5:] == (["breakdown"] if trace else []) + ["card", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    json.dumps(res)
    want = harness.cell_metrics(BENCH, name, trace)
    for m, v in res["metrics"].items():
        assert v["unit"] == want[m]
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == set(want)
        assert res["metrics"]["setup_s"]["value"] > 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A configuration, a cell and a per-layer metric added as files (and
    entries of BENCHMARK.json) run through an unchanged harness."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    wl, cfg = tiny.shrink("paper.train_gcd_r")
    cfg["name"] = "paper-tiny"
    wl["config"] = "paper_tiny"
    (root / "perfbench/configs/paper_tiny.json").write_text(json.dumps(cfg))
    (root / "perfbench/workloads/paper_tiny.train.json").write_text(
        json.dumps(wl))
    (root / "perfbench/metrics/steps_seen.train.py").write_text(
        "def read(rec):\n    return rec.host.get('steps')\n")
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="paper_tiny.train",
                                   config="paper_tiny", traffic="train",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="steps_seen.train", unit="steps", better="higher",
        source="host_clock", layer="whole step",
        moves="train_examples_per_s", workloads=["paper_tiny.train"]))
    for m in bench["end_to_end"]:
        if "train_examples_per_s" == m["name"]:
            m["workloads"].append("paper_tiny.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "copied_harness", root / "perfbench/harness.py")
    h = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(h)
    res = h.run_cell("paper_tiny.train", h.workload("paper_tiny.train"),
                     h.config("paper_tiny"), h.benchmark(), tiny.SEED,
                     tiny.SECONDS, True, tiny.CPU, 0.0)
    assert res["correct"]
    assert res["metrics"]["steps_seen.train"]["value"] == res["attempted"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
    with pytest.raises(FileNotFoundError):
        harness.workload("no.such_cell")


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from perfbench import run

    for var in ("USE_FLAX", *run.THREAD_VARS):
        monkeypatch.setenv(var, "1")
    monkeypatch.setattr("torch.set_num_threads", lambda n: None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", tiny.CELLS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    out = capsys.readouterr().out
    assert out == ""


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_in(["repro_torch.search", "reprox", "jaxtyping",
                                 "flaxen.a"]) == []
    assert harness.forbidden_in(["repro.index.ivf", "jax", "jaxlib.xla",
                                 "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]


def test_intervals():
    assert harness.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert harness.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
