"""The port's roofline model (``repro_torch.roofline.analysis``) against the
JAX package's (``repro/roofline/analysis.py``, which imports only ``re``)
and against hand-computed values under the H100 constants; the one-card
mesh; the kernels' closed-form FLOPs against FlopCounterMode's count of
their plain versions."""
from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as jax_analysis
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis


@pytest.mark.parametrize("b,Dp,K,steps,block,lut,code_bytes,per_step", [
    (8, 64, 256, 64, 1024, "float32", 1, 8),
    (8, 64, 256, 64, 1024, "int8", 1, 8),
    (1, 32, 256, 300, 128, "uint8", 1, 1),
    (64, 24, 200, 17, 512, "float32", 2, 1),
])
def test_adc_scan_traffic_equals_jax(b, Dp, K, steps, block, lut, code_bytes,
                                     per_step):
    kw = dict(lut_dtype=lut, code_bytes=code_bytes, luts_per_step=per_step)
    assert analysis.adc_scan_traffic(b, Dp, K, steps, block, **kw) == \
        jax_analysis.adc_scan_traffic(b, Dp, K, steps, block, **kw)


@pytest.mark.parametrize("b,n,Dp,K,sub", [
    (8, 512, 64, 256, 8), (512, 256, 32, 256, 8), (1, 128, 16, 16, 8),
    (37, 192, 24, 250, 8),
])
def test_fused_lut_traffic_equals_jax(b, n, Dp, K, sub):
    assert analysis.fused_lut_traffic(b, n, Dp, K, sub) == \
        jax_analysis.fused_lut_traffic(b, n, Dp, K, sub)


def test_h100_constants():
    assert analysis.PEAK_FLOPS_BF16 == 989e12
    assert analysis.PEAK_FLOPS_F32 == 67e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 900e9
    assert analysis.CHIP_HBM_BYTES == 80e9
    assert analysis.peak_flops(torch.bfloat16) == 989e12
    assert analysis.peak_flops(torch.float16) == 989e12
    assert analysis.peak_flops(torch.float32) == 67e12


def test_roofline_terms_by_hand():
    # 989e12 FLOPs in bf16 is one second; 3.35e12 bytes is one second
    t = analysis.roofline_terms(989e12, 3.35e12 / 2, 0.0)
    assert t["compute_s"] == pytest.approx(1.0, rel=1e-15)
    assert t["memory_s"] == pytest.approx(0.5, rel=1e-15)
    assert t["collective_s"] == 0.0
    assert t["dominant"] == "compute"
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = analysis.roofline_terms(67e12, 6.7e12, 450e9,
                                peak=analysis.PEAK_FLOPS_F32)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == \
        pytest.approx((1.0, 2.0, 0.5))
    assert t["dominant"] == "memory"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert analysis.roofline_terms(0.0, 0.0)["roofline_fraction"] == 0.0


def test_kernel_predicted_by_hand():
    # gcd_score at n = 512: 2n³ float32 operations over three n×n matrices
    n = 512
    p = analysis.kernel_predicted(2.0 * n ** 3, 3 * n * n * 4.0)
    assert p["dominant"] == "compute"
    assert p["predicted_us"] == pytest.approx(2.0 * n ** 3 / 67e12 * 1e6)
    assert (p["flops"], p["bytes"]) == (2.0 * n ** 3, 3 * n * n * 4.0)
    # a scan: bytes dominate
    p = analysis.kernel_predicted(1e6, 3.35e9)
    assert p["dominant"] == "memory"
    assert p["predicted_us"] == pytest.approx(1e3)


def test_analyze_has_the_jax_keys():
    rep = analysis.analyze(2e15, 1e12, 40e9, model_flops_total=1.5e15)
    for k in ("flops_per_device", "bytes_per_device", "loop_trips",
              "collective_bytes", "bytes_by_op", "counts_by_op", "compute_s",
              "memory_s", "collective_s", "dominant", "roofline_fraction",
              "model_flops_total", "model_flops_per_device",
              "useful_compute_ratio"):
        assert k in rep, k
    assert rep["memory"] == {"peak_bytes": 40e9, "hbm_limit": 80e9}
    assert rep["loop_trips"] == 1.0 and rep["collective_bytes"] == 0.0
    assert rep["useful_compute_ratio"] == pytest.approx(0.75)
    assert rep["compute_s"] == pytest.approx(2e15 / 989e12)


def test_one_card_mesh_and_the_production_meshes_raise():
    mesh = mesh_lib.make_host_mesh("cpu")
    assert analysis.num_chips(mesh) == 1
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.name == "1xCPU"
    for fn in (lambda: mesh_lib.make_production_mesh(),
               lambda: mesh_lib.make_production_mesh(multi_pod=True),
               lambda: mesh_lib.make_data_mesh(4)):
        with pytest.raises(NotImplementedError, match="item 11"):
            fn()
    assert mesh_lib.CHIP_HBM_BYTES == analysis.CHIP_HBM_BYTES
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_host_mesh()


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as c:
        fn()
    return float(c.get_total_flops())


def test_kernel_flops_equal_flopcounter_on_the_plain_matmuls():
    g = torch.Generator().manual_seed(0)
    G, R = torch.randn(48, 48, generator=g), torch.randn(48, 48, generator=g)
    assert analysis.kernel_flops("gcd_score", [G.shape, R.shape]) == \
        _counted(lambda: ref.gcd_score_ref(G, R))
    X = torch.randn(100, 64, generator=g)
    C = torch.randn(8, 32, 8, generator=g)
    assert analysis.kernel_flops("pq_assign", [X.shape, C.shape]) == \
        _counted(lambda: ref.pq_assign_ref(X, C))
    Q, qd = torch.randn(5, 64, generator=g), torch.randn(64, 64, generator=g)
    cb, colmap = torch.randn(8, 16, 8, generator=g), torch.eye(8)
    want = (analysis.kernel_flops("fused_lut", [Q.shape, qd.shape, cb.shape,
                                                colmap.shape]))
    # the plain version also multiplies by the one-hot map, which the
    # kernel reads as an index: 2·b·Dp·D·sub more
    assert want + 2 * 5 * 8 * 8 * 8 == _counted(
        lambda: ref.fused_lut_ref(Q, qd, cb, colmap))


def test_kernel_flops_closed_forms():
    kf = analysis.kernel_flops
    assert kf("givens_rotate", [(8192, 512), (256,), (256,), (256,),
                                (256,)]) == 6.0 * 8192 * 256
    assert kf("embedding_bag", [(100_000, 64), (16384,), (16384,)]) == \
        2.0 * 16384 * 64
    assert kf("adc_lookup", [(8, 64, 256), (65536, 64)]) == 8 * 65536 * 64
    assert kf("adc_batch", [(16, 1, 16, 256), (16, 524288, 16)]) == \
        16 * 524288 * 16
    assert kf("ivf_adc", [(512, 32, 256), (1024 * 128, 32), (294912,),
                          (294912,)], block_size=128) == 294912 * 128 * 32
    with pytest.raises(KeyError):
        kf("topk_merge", [])
    assert math.isfinite(kf("pq_assign", [(1, 128), (16, 256, 8)]))
