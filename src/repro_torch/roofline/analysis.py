"""Roofline terms of one H100 SXM (port of ``repro/roofline/analysis.py``).

Three terms per cell or kernel launch, in seconds:

  compute    = FLOPs / the peak of the work's type
  memory     = bytes / HBM bandwidth
  collective = collective bytes / NVLink bandwidth (0 on one card)

The JAX module reads the FLOPs and bytes of a compiled XLA executable
(``cost_analysis``, ``memory_analysis``, the HLO text). PyTorch has no
compiled executable to ask, so ``analyze`` takes what ``launch.dryrun``
measured on the card: ``FlopCounterMode``'s count plus the hand-written
kernels' closed-form FLOPs, the closed-form bytes a step moves, and the
peak of ``torch.cuda.max_memory_allocated``. ``collective_stats``, an
HLO-text parser, has no counterpart on one card (ROADMAP.md, "Not
ported, by design").

The peak follows the work: the models' GEMMs in bf16 on the tensor cores
(``PEAK_FLOPS_BF16``), float32 models (the port runs them without TF32)
and the hand-written kernels, which use float32 FMAs, at
``PEAK_FLOPS_F32`` — the bound column of ``PERF.md`` §6.
"""
from __future__ import annotations

from typing import Any

# H100 SXM5, NVIDIA's data sheet (the "H100 SXM" column; dense, without
# sparsity) — the ONE source of the card's numbers for the roofline and
# the dry run's capacity check (launch.mesh re-exports them).
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor core, dense
PEAK_FLOPS_F32 = 67e12         # FLOP/s, float32 (non-tensor)
HBM_BW = 3.35e12               # bytes/s, HBM3
NVLINK_BW = 900e9              # bytes/s, NVLink 4, all links together
CHIP_HBM_BYTES = 80e9          # bytes, HBM3 (80 GB)


def num_chips(mesh) -> int:
    """Total devices of a mesh (``mesh.shape``: axis name -> size)."""
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


def peak_flops(dtype) -> float:
    """The peak that matches work in ``dtype``: bf16 (and fp16) on the
    tensor cores, anything else at the float32 rate."""
    return (PEAK_FLOPS_BF16 if str(dtype).rsplit(".", 1)[-1]
            in ("bfloat16", "float16") else PEAK_FLOPS_F32)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float = 0.0, *,
                   peak: float = PEAK_FLOPS_BF16) -> dict[str, float]:
    compute = flops_per_device / peak
    memory = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        # the share of the bound that is useful compute: the roofline score
        "roofline_fraction": (compute / bound) if bound > 0 else 0.0,
    }


def analyze(flops_per_device: float, bytes_per_device: float,
            peak_bytes: float, model_flops_total: float | None = None,
            n_chips: int = 1, *, peak: float = PEAK_FLOPS_BF16,
            hbm_limit: float = CHIP_HBM_BYTES) -> dict[str, Any]:
    """A cell's report under the JAX report's keys, from measured counts:
    ``flops_per_device`` (the counted FLOPs of one step or call),
    ``bytes_per_device`` (the closed-form bytes it moves), ``peak_bytes``
    (the measured or extrapolated peak). One card runs the whole step, so
    ``loop_trips`` is 1.0 and there are no collectives."""
    out = {
        "flops_per_device": float(flops_per_device),
        "bytes_per_device": float(bytes_per_device),
        "loop_trips": 1.0,
        "bytes_by_op": {},
        "counts_by_op": {},
        "collective_bytes": 0.0,
        "memory": {"peak_bytes": float(peak_bytes),
                   "hbm_limit": float(hbm_limit)},
        **roofline_terms(flops_per_device, bytes_per_device, 0.0,
                         peak=peak),
    }
    if model_flops_total is not None and flops_per_device > 0:
        out["model_flops_total"] = float(model_flops_total)
        out["model_flops_per_device"] = model_flops_total / n_chips
        out["useful_compute_ratio"] = ((model_flops_total / n_chips)
                                       / flops_per_device)
    return out


# ---------------------------------------------------------------------------
# kernel-level predicted-vs-measured
# ---------------------------------------------------------------------------

def kernel_predicted(flops: float, bytes_moved: float,
                     collective_bytes: float = 0.0, *,
                     peak: float = PEAK_FLOPS_F32) -> dict[str, Any]:
    """Roofline bound of one kernel launch, in µs, at the float32 rate the
    hand-written kernels run at (``bench.kernels_micro`` books it beside
    the measured time)."""
    t = roofline_terms(flops, bytes_moved, collective_bytes, peak=peak)
    return {
        "predicted_us": max(t["compute_s"], t["memory_s"],
                            t["collective_s"]) * 1e6,
        "dominant": t["dominant"],
        "flops": flops,
        "bytes": bytes_moved,
    }


def adc_scan_traffic(b: int, Dp: int, K: int, steps: int, block: int,
                     lut_dtype: str = "float32", code_bytes: int = 1,
                     luts_per_step: int = 1) -> float:
    """Modeled HBM traffic (bytes) of one ADC scan launch, the JAX model:
    per grid step ``luts_per_step`` LUT rows (float32, or 1 byte an entry
    plus the float32 (Dp, 2) scale/offset sidecar), one (block, Dp) code
    tile and one (b, block) float32 score tile."""
    lut_entry = 4 if lut_dtype == "float32" else 1
    scales = 0 if lut_dtype == "float32" else Dp * 2 * 4
    lut_row = luts_per_step * (Dp * K * lut_entry + scales)
    codes_blk = block * Dp * code_bytes
    out_blk = b * block * 4
    return float(steps) * (lut_row + codes_blk + out_blk)


def fused_lut_traffic(b: int, n: int, Dp: int, K: int, sub: int) -> float:
    """Modeled HBM traffic (bytes) of one fused rotation-aware LUT build:
    queries (b, n) + delta product (n, n) + flat codebooks (Dp, K, sub) +
    one-hot column map (Dp, n) in, (b, Dp, K) f32 table out."""
    return 4.0 * (b * n + n * n + Dp * K * sub + Dp * n + b * Dp * K)


def kernel_flops(name: str, shapes: list, block_size: int = 128) -> float:
    """Closed-form operations of one launch of a hand-written kernel from
    its operands' shapes (``shapes``: the wrapper's positional operands,
    None where an operand is not a tensor; ``block_size``, ``ivf_adc``'s
    rows a tile). ``FlopCounterMode`` cannot see
    the kernels, so the dry run adds these for each launch it counts."""
    s = shapes
    if name == "gcd_score":                  # M = GᵀR; A = M − Mᵀ
        n = s[1][0]
        return 2.0 * n ** 3
    if name == "givens_rotate":              # 6 a pair a row
        m, _ = s[0]
        return 6.0 * m * s[1][0]
    if name == "pq_assign":                  # ⟨x, C[d, k]⟩ for every k
        m = s[0][0]
        D, K, sub = s[1]
        return 2.0 * m * D * K * sub
    if name == "embedding_bag":              # a multiply-add an element
        return 2.0 * s[1][0] * s[0][1]
    if name == "adc_lookup":                 # b·N·Dp table adds
        b, Dp, _ = s[0]
        return float(b * s[1][0] * Dp)
    if name == "adc_batch":                  # g·r·S·Dp table adds
        g, r, Dp, _ = s[0]
        return float(g * r * s[1][1] * Dp)
    if name == "ivf_adc":                    # every scheduled tile's adds
        return float(s[2][0] * block_size * s[1][1])
    if name == "fused_lut":                  # Q·qdelta, then the tables
        b, n = s[0]
        Dp, K, sub = s[2]
        return 2.0 * b * n * n + 2.0 * b * Dp * K * sub
    raise KeyError(f"no closed form for kernel {name!r}")
