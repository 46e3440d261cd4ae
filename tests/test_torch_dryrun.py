"""The port's launch layer: ``configs.grid_cells``, ``launch.cells`` against
the JAX package's cells (``repro.launch.cells`` on ``make_host_mesh``; the
JAX ``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS``
at import), and ``launch.dryrun`` on the CPU at the smoke configs: the
record's keys, the FLOP count, the fits, the plans and the CLI."""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import cells, dryrun

JAX_KEYS = ("arch", "shape", "mesh", "ok", "kind", "n_chips", "fits_hbm",
            "report")
REPORT_KEYS = ("flops_per_device", "bytes_per_device", "loop_trips",
               "collective_bytes", "compute_s", "memory_s", "collective_s",
               "dominant", "roofline_fraction", "memory",
               "model_flops_total", "useful_compute_ratio")


def test_grid_cells_are_the_jax_grid():
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert configs.grid_cells() == jconfigs.grid_cells()
    assert len(configs.grid_cells()) == 40


_JAX_META = {}


def _jax_meta(aid, shape):
    if not _JAX_META:
        mesh = jmesh.make_host_mesh()
        for a, s in jconfigs.grid_cells():
            _JAX_META[(a, s)] = jcells.build_cell(a, s, mesh).meta
    return _JAX_META[(aid, shape)]


@pytest.mark.parametrize("aid,shape", jconfigs.grid_cells())
def test_cell_meta_equals_jax(aid, shape):
    want = _jax_meta(aid, shape)
    got = cells.build_cell(aid, shape).meta
    assert got["kind"] == want["kind"]
    assert got["model_flops"] == pytest.approx(want["model_flops"],
                                               rel=1e-12)


# one cell of each of the nine kinds
NINE = [("olmo-1b", "train_4k"), ("qwen1.5-4b", "prefill_32k"),
        ("grok-1-314b", "long_500k"), ("graphsage-reddit", "full_graph_sm"),
        ("graphsage-reddit", "minibatch_lg"), ("graphsage-reddit",
                                               "molecule"),
        ("two-tower-retrieval", "train_batch"), ("wide-deep", "serve_p99"),
        ("two-tower-retrieval", "retrieval_cand")]


@pytest.mark.parametrize("aid,shape", NINE)
def test_run_cell_on_the_cpu_has_every_jax_key(aid, shape):
    rec = dryrun.run_cell(aid, shape, device="cpu", verbose=False)
    assert rec["ok"], rec.get("traceback")
    for k in JAX_KEYS:
        assert k in rec, k
    for k in REPORT_KEYS:
        assert k in rec["report"], k
    rep = rec["report"]
    assert rec["mesh"] == "1xCPU" and rec["n_chips"] == 1
    assert rep["collective_bytes"] == 0.0 and rep["loop_trips"] == 1.0
    assert rep["memory"]["hbm_limit"] == 80e9
    assert rec["fits_hbm"] is True
    assert rec["measured_at"] and rec["step_s"] > 0
    assert rep["flops_per_device"] > 0 and rep["bytes_per_device"] > 0
    meta = cells.build_cell(aid, shape, smoke=True).meta
    assert rep["model_flops_total"] == meta["model_flops"]
    assert rec["kind"] == meta["kind"]
    assert rec["reduced"][0].startswith("smoke config")
    json.dumps(rec)


@pytest.mark.parametrize("aid,shape", [("wide-deep", "train_batch"),
                                       ("olmo-1b", "train_4k"),
                                       ("olmo-1b", "decode_32k")])
def test_flop_count_no_lower_than_model_flops_on_gemm_cells(aid, shape):
    rec = dryrun.run_cell(aid, shape, device="cpu", verbose=False)
    rep = rec["report"]
    assert rep["flops_per_device"] >= rep["model_flops_total"]
    if shape == "train_4k":
        # remat runs each layer's forward again: about 8N/6N
        assert 0.6 < rep["useful_compute_ratio"] < 0.8


def test_train_cells_restore_the_deterministic_mode():
    was = torch.are_deterministic_algorithms_enabled()
    rec = dryrun.run_cell("din", "train_batch", device="cpu", verbose=False)
    assert rec["ok"]
    assert torch.are_deterministic_algorithms_enabled() == was


def _points(f, depths, batches):
    return [dict(depth=d, batch=b, v=f(d, b)) for b in batches
            for d in depths]


@pytest.mark.parametrize("depths,batches", [((1, 2), (32,)), ((2, 4), (32,)),
                                            ((None,), (8, 4)),
                                            ((1, 2), (4, 2))])
def test_extrapolation_is_exact_on_linear_data(depths, batches):
    def f(d, b):
        return 3.0 + 5.0 * (d or 0) + 7.0 * b + 0.5 * (d or 0) * b
    pts = _points(f, depths, batches)
    D = 96 if depths != (None,) else None
    B = 128 if len(batches) > 1 else batches[0]
    assert dryrun.extrapolate(pts, "v", D, B) == pytest.approx(f(D, B),
                                                               rel=1e-12)


def test_cut_depths_keep_the_interleave():
    assert dryrun.cut_depths(configs.get("olmo-1b").make_config()) == (1, 2)
    llama = configs.get("llama4-maverick-400b-a17b").make_config()
    assert dryrun.cut_depths(llama) == (2, 4)
    assert cells.at_depth(llama, 4).num_layers == 4
    with pytest.raises(ValueError, match="interleave"):
        cells.at_depth(llama, 3)


def test_reckoning_grows_with_depth_and_batch():
    cell = cells.build_cell("olmo-1b", "train_4k")
    full = cell.meta["cfg"]
    r1 = dryrun.reckon(cell, cells.at_depth(full, 1), 2, 2)["peak_bytes"]
    r2 = dryrun.reckon(cell, cells.at_depth(full, 2), 2, 2)["peak_bytes"]
    r3 = dryrun.reckon(cell, cells.at_depth(full, 2), 4, 2)["peak_bytes"]
    assert r1 < r2 < r3
    # olmo-1b's 1.28B bf16 parameters and their float32 AdamW moments
    terms = dryrun.reckon(cell, full, 2, 8)["terms"]
    assert terms["params"] == pytest.approx(2 * 1.28e9, rel=0.01)
    assert terms["moments"] == 4 * terms["params"]
    assert terms["accumulation"] == 2 * terms["params"]


def test_plans_cut_what_does_not_fit():
    # olmo-1b's train_4k: whole, then full depth at a cut microbatch, then
    # two depths at the cell's microbatch
    cell = cells.build_cell("olmo-1b", "train_4k")
    ladder = dryrun.plans(cell, 0.92 * 80e9)
    assert [p.why for p in ladder[:2]] == ["whole", dryrun.FULL_DEPTH]
    assert ladder[0].steps == dryrun.WHOLE_STEPS and ladder[0].accum == 8
    assert ladder[2].depths == (1, 2) and ladder[2].batches == (32,)
    ladder = dryrun.plans(cell, 50e9)
    assert ladder[0].why == dryrun.FULL_DEPTH
    # nemotron-4 cannot run whole: depths and batches cut
    cell = cells.build_cell("nemotron-4-340b", "decode_32k")
    ladder = dryrun.plans(cell, 0.92 * 80e9)
    assert ladder and all(p.why != "whole" for p in ladder)
    assert ladder[-1].depths == (1, 2) and len(ladder[-1].batches) == 2
    # a small serve cell runs whole (cut batches as the fallback)
    ladder = dryrun.plans(cells.build_cell("wide-deep", "serve_p99"), 80e9)
    assert ladder[0] == dryrun.Plan((None,), (512,), 1, 1, "whole")
    assert ladder[1].batches == (256, 128)
    # nothing fits a tiny card: the reckoning alone
    assert dryrun.plans(cells.build_cell("wide-deep", "train_batch"),
                        1e6) == []


def test_a_cut_plan_extrapolates_to_the_cells_depth():
    plan = dryrun.Plan((1, 2), (None,), 2, 1, "depths (1, 2) of 2")
    cell = cells.build_cell("olmo-1b", "train_4k", smoke=True)
    B = cell.meta["batch"]
    plan = plan._replace(batches=(B,))
    rec = dryrun.run_cell("olmo-1b", "train_4k", device="cpu", plan=plan,
                          verbose=False)
    assert rec["ok"], rec.get("traceback")
    pts = rec["measured_at"]
    assert [(p["depth"], p["batch"], p["accum"]) for p in pts] == \
        [(1, B, 2), (2, B, 2)]
    # the smoke config has 2 layers: the fit lands on the depth-2 run,
    # the step's FLOPs scaled from accumulation 2 to the cell's 8
    A = cell.meta["accum"]
    assert rec["report"]["flops_per_device"] == pytest.approx(
        pts[1]["flops"] * A / 2)
    assert rec["step_s"] == pytest.approx(
        pts[1]["optimizer_s"] + A * pts[1]["micro_s"])
    assert "accumulation 8 -> 2: a step = optimizer + 8 microbatches" in \
        rec["reduced"]


def test_reckoned_only_record_when_nothing_fits(monkeypatch):
    monkeypatch.setattr(dryrun, "plans", lambda cell, budget: [])
    rec = dryrun.run_cell("mind", "serve_p99", device="cpu", verbose=False)
    assert rec["ok"] and rec["measured_at"] == []
    assert rec["reduced"][-1] == "no run fits one card: the reckoning alone"
    assert rec["report"]["useful_compute_ratio"] is None
    assert rec["peak_from"] == "reckoning" and rec["step_s"] is None


def test_largest_microbatch_from_two_probes(monkeypatch):
    """Peaks of 10 + 2·b GB: at a 40 GB budget the largest even microbatch
    is 14; the whole steps run there, and the cell's own 32 is fitted from
    the probe at 4 and the whole run at 14."""
    cell = cells.build_cell("olmo-1b", "train_4k")
    runs = []

    def fake(cell_, depth, batch, accum, dev, steps=1, seed=0):
        runs.append((depth, batch, accum, steps))
        return dict(depth=None, batch=batch, accum=accum, flops=1.0,
                    launches={}, calls=1 + steps, step_s=float(batch),
                    step_s_all=[float(batch)] * steps,
                    peak_bytes=(10 + 2 * batch) * 1e9, grads_s=1.0,
                    optimizer_s=0.5, micro_s=1.0 / accum)
    monkeypatch.setattr(dryrun, "measure", fake)
    points, summary, notes = dryrun.largest_microbatch(
        cell, torch.device("cpu"), 40e9)
    assert runs == [(None, 2, 2, 1), (None, 4, 2, 1),
                    (None, 14, 8, dryrun.WHOLE_STEPS)]
    assert summary["microbatch"] == 14 and summary["accum"] == 8
    assert summary["tokens_per_s"] == 14 * 8 * 4096 / 14.0
    assert [p["batch"] for p in points] == [4, 14]
    assert "microbatch 32 -> 14" in notes[0]


def test_kernel_work_adds_closed_forms_only_for_launches(monkeypatch):
    """On the CPU a wrapper launches nothing and adds nothing; a call whose
    counter moves adds its closed form once a launch."""
    X, C = torch.randn(10, 16), torch.randn(2, 8, 8)
    work = {}
    with dryrun.kernel_work(work):
        ops.pq_assign(X, C)
    assert work == {"flops": 0.0, "launches": {}}
    real = ops.pq_assign

    def launching(*a, **k):
        ops.LAUNCHES["pq_assign"] += 1
        return real(*a, **k)
    monkeypatch.setattr(ops, "pq_assign", launching)
    before = dict(ops.LAUNCHES)
    work = {}
    with dryrun.kernel_work(work):
        ops.pq_assign(X, C)
        ops.pq_assign(X, C)
    assert work["launches"] == {"pq_assign": 2}
    assert work["flops"] == 2 * 2.0 * 10 * 2 * 8 * 8
    assert ops.pq_assign is launching
    ops.LAUNCHES.update(before)


def test_main_writes_only_to_out(tmp_path, capsys):
    assert dryrun.main(["--arch", "wide-deep", "--shape", "serve_p99",
                        "--device", "cpu"]) == 0
    assert "1 ok, 0 failed" in capsys.readouterr().out
    out = tmp_path / "records"
    assert dryrun.main(["--arch", "wide-deep", "--shape", "serve_p99",
                        "--device", "cpu", "--out", str(out)]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert files == ["wide-deep__serve_p99__1xCPU.json"]
    rec = json.loads((out / files[0]).read_text())
    assert rec["ok"] and math.isfinite(rec["report"]["compute_s"])
    assert dryrun.main(["--arch", "wide-deep", "--shape", "serve_p99",
                        "--device", "cpu", "--out", str(out),
                        "--skip-existing"]) == 0
    assert "1 skipped" in capsys.readouterr().out


def test_whole_after_a_fit_that_fits(monkeypatch):
    """A cut plan whose fitted peak fits the card is followed by a whole
    run, which replaces the fit; one whose fit does not is kept."""
    cell = cells.build_cell("wide-deep", "serve_bulk")
    B = cell.meta["batch"]

    def fake(cell_, depth, batch, accum, dev, steps=1, seed=0):
        return dict(depth=None, batch=batch, accum=accum, flops=1.0,
                    launches={}, calls=2, step_s=1.0, step_s_all=[1.0],
                    peak_bytes=1e9 * batch / B)
    monkeypatch.setattr(dryrun, "measure", fake)
    cut = dryrun.Plan((None,), (B // 2, B // 4), 1, 1, "batch cut")
    pts = [fake(cell, None, b, 1, None) for b in cut.batches]
    reduced = []
    got, plan = dryrun._whole_after_fit(cell, pts, cut, torch.device("cpu"),
                                        0, reduced)
    assert plan.why == "whole" and [p["batch"] for p in got] == [B]
    assert reduced[0].startswith("measured whole: the reckoning did not fit")
    big = [dict(p, peak_bytes=p["peak_bytes"] * 1e3) for p in pts]
    got, plan = dryrun._whole_after_fit(cell, big, cut, torch.device("cpu"),
                                        0, [])
    assert plan is cut and got is big


def test_global_norm_chunks_a_leaf_too_long_for_one_dot(monkeypatch):
    """A float32 leaf over ``DOT_MAX`` elements (two-tower-retrieval's
    10M × 256 table on the card) is summed in NORM_CHUNK pieces."""
    from repro_torch.training import optimizer as opt_lib

    g = torch.Generator().manual_seed(1)
    grads = {"a": torch.randn(1000, 7, generator=g),
             "b": torch.randn(33, generator=g)}
    want = math.sqrt(sum(float((v.double() ** 2).sum())
                         for v in grads.values()))
    monkeypatch.setattr(opt_lib, "DOT_MAX", 100)
    monkeypatch.setattr(opt_lib, "NORM_CHUNK", 64)
    calls = []
    real = torch.dot
    monkeypatch.setattr(torch, "dot", lambda a, b: (calls.append(a.numel()),
                                                   real(a, b))[1])
    got = float(opt_lib.global_norm(grads))
    assert got == pytest.approx(want, rel=1e-6)
    assert max(calls) == 64 and calls[-1] == 33


def test_a_whole_run_out_of_memory_does_not_fit(monkeypatch):
    """A whole run that runs out of memory sends the cell to its next plan
    and makes ``fits_hbm`` false, whatever the cut runs' fit says."""
    real = dryrun.measure
    B = cells.build_cell("din", "serve_p99", smoke=True).meta["batch"]

    def measure(cell, depth, batch, accum, dev, steps=1, seed=0):
        if batch == B:
            raise torch.OutOfMemoryError("CUDA out of memory (a test)")
        return real(cell, depth, batch, accum, dev, steps, seed)
    monkeypatch.setattr(dryrun, "measure", measure)
    monkeypatch.setattr(dryrun, "plans", lambda cell, budget: [
        dryrun.Plan((None,), (B,), 1, 1, "whole"),
        dryrun.Plan((None,), (B // 2, B // 4), 1, 1, "batch cut")])
    rec = dryrun.run_cell("din", "serve_p99", device="cpu", verbose=False)
    assert rec["ok"] and rec["fits_hbm"] is False
    assert rec["reduced"][1].startswith("whole: out of memory")
    assert rec["reduced"][2] == "batch cut"
    assert [p["batch"] for p in rec["measured_at"]] == [B // 2, B // 4]
