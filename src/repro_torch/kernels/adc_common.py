"""LUT quantization shared by the ADC scan kernels (port of
``repro/kernels/adc_common.py``).

The scans stream one (Dp, K) lookup table per query. Storing it int8/uint8
with a per-(query, column) ``[scale, offset]`` sidecar quarters the LUT
bytes; the CUDA scan (``csrc/adc_scan.cu``) dequantizes each row into
shared memory exactly as ``dequantize_luts`` does here.

The TPU one-hot tile body (``adc_tile_scores``) exists only because gathers
are slow on a TPU and has no counterpart here: on Hopper the scan gathers
from a LUT held in shared memory.
"""
from __future__ import annotations

import torch

#: LUT dtypes the scan kernels accept. "float32" means a plain table; the
#: integer dtypes mean a (qlut, scales) pack from quantize_luts.
LUT_DTYPES = ("float32", "int8", "uint8")


def quantize_luts(lut: torch.Tensor, dtype: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ADC tables per (query, code-column) subspace.

    lut (..., Dp, K) float -> (qlut (..., Dp, K) int8|uint8, scales
    (..., Dp, 2) float32) with ``lut ≈ qlut * scale + offset``. int8 is
    symmetric (offset 0, scale = amax/127); uint8 is affine over [min, max].
    A constant column gets scale 1 so it dequantizes exactly via the offset.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    lut = lut.float()
    if dtype == "int8":
        amax = lut.abs().amax(dim=-1)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
        offset = torch.zeros_like(scale)
        q = torch.clamp(torch.round(lut / scale[..., None]), -127, 127)
        qlut = q.to(torch.int8)
    elif dtype == "uint8":
        lo = lut.amin(dim=-1)
        hi = lut.amax(dim=-1)
        rng = hi - lo
        scale = torch.where(rng == 0.0, torch.ones_like(rng), rng / 255.0)
        offset = lo
        q = torch.clamp(torch.round((lut - lo[..., None]) / scale[..., None]),
                        0, 255)
        qlut = q.to(torch.uint8)
    else:
        raise ValueError(f"quantize_luts: dtype must be int8|uint8, "
                         f"got {dtype!r}")
    return qlut, torch.stack([scale, offset], dim=-1)


def dequantize_luts(qlut: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Invert quantize_luts: (..., Dp, K) int + (..., Dp, 2) -> f32 tables
    (``q * scale + offset``, two roundings, as the kernel does)."""
    return (qlut.float() * scales[..., 0][..., None]
            + scales[..., 1][..., None])
