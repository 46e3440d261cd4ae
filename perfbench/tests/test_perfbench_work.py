"""The frozen work counts and the per-layer arithmetic on hand-computed
shapes."""
from __future__ import annotations

import pytest

from perfbench.tests import tiny  # noqa: F401  (puts the repo on the path)
from perfbench import harness
from perfbench.work import peaks, serve, train


def test_serve_counts():
    # b=2, n=4, L=3, D=2, K=5, 10 probed rows over the queries
    assert serve.batch_flops(2, 4, 3, 2, 5, 10) == 64 + 48 + 80 + 30
    # reads 4·(8 + 16 + 12 + 20); 7 union rows of 2 + 4 bytes; 2·3 results
    assert serve.batch_bytes(2, 4, 3, 2, 5, 3, 7) == 224 + 42 + 48
    assert serve.scan_bytes(2, 2, 5, 7, 10) == 80 + 42 + 40


def test_train_counts():
    # B=2, H=3, e=4, towers (4,), n=4, K=5, P=100
    mlp = 2 * 2 * 4 * 4                 # one layer, one tower
    rot = 2 * 2 * 4 * 4                 # one (B, n) x (n, n) rotation
    scores = 2 * 2 * 2 * 4              # (B, n) x (n, B)
    fwd = 2 * 3 * 4 + 2 * mlp + 2 * rot + 2 * 2 * 4 * 5 + scores + 4 * 4
    bwd = 2 * (2 * mlp + 2 * rot + scores) + 2 * 4 + 2 * 3 * 4
    assert train.step_flops(2, 3, 4, (4,), 4, 5, 100) == \
        fwd + bwd + 1200 + 128
    assert train.step_bytes(100) == 2400
    # table 10·4, two towers of 4·4 + 4, codebooks 5·4
    assert train.trainable_elements(10, 4, (4,), 5, 4) == 40 + 40 + 20


def test_bound():
    assert peaks.bound_s(67e12, 1.0) == (1.0, "flops")
    assert peaks.bound_s(1.0, 3.35e12) == (1.0, "bytes")


def rec(**kw):
    base = dict(device_ops=[("ivf_adc_kernel<float>", 0.0, 0.5),
                            ("topk", 0.25, 0.5), ("copy", 1.5, 0.25)],
                window_s=2.0, host={}, marks={}, work={})
    base.update(kw)
    return harness.Records(**base)


def read(name, r):
    return harness.load_module("metrics", name).read(r)


def test_device_readers():
    r = rec(host=dict(batches=4, submit_s=[0.001, 0.003]),
            work=dict(flops=67e12, bytes=3.35e12 * 0.5,
                      scan_bytes=3.35e12 * 0.25))
    assert read("search_device_ms.serve", r) == pytest.approx(1.25 / 4 * 1e3)
    assert read("engine_submit_ms.serve", r) == pytest.approx(2.0)
    assert read("ivf_adc_roofline.serve", r) == pytest.approx(50.0)
    # busy 1.0 s of 2.0: the first two overlap
    assert read("device_idle_share.serve", r) == pytest.approx(50.0)
    assert read("device_idle_share.train", r) == pytest.approx(50.0)
    # 1 s of float32 work in a 2 s window
    assert read("mfu.serve", r) == pytest.approx(50.0)
    assert read("mfu.train", r) == pytest.approx(50.0)


def test_mark_readers():
    r = rec(marks=dict(forward=[2.0, 4.0], backward=[1.0, 1.0],
                       adamw=[3.0, 5.0], rotation=[0.5, 1.5]))
    assert read("fwd_bwd_ms.train", r) == pytest.approx(4.0)
    assert read("adamw_ms.train", r) == pytest.approx(4.0)
    assert read("rotation_ms.train", r) == pytest.approx(1.0)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.benchmark()["per_layer"]])
def test_readers_return_nothing_without_data(name):
    empty = harness.Records([], 0.0, {}, {}, {})
    assert read(name, empty) is None
