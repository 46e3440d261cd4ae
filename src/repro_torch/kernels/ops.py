"""Public wrappers around the port's kernels (port of
``repro/kernels/ops.py``).

The device of the tensors decides, and there is no ``use_kernel`` switch:

  * CPU tensors go to the plain PyTorch version in ``kernels/ref.py``;
  * CUDA tensors go to the hand-written Hopper kernel in ``csrc/`` — the
    wrapper checks device, dtype, shape and contiguity, allocates the
    output, launches on the current stream and raises on a launch error.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its path went through the kernel.
``topk_merge`` has no kernel, as in the JAX package: it is plain torch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.adc_common import (  # noqa: F401
    LUT_DTYPES,
    dequantize_luts,
    quantize_luts,
)

__all__ = ["gcd_score", "adc_lookup", "ivf_adc", "topk_merge",
           "quantize_luts", "dequantize_luts", "LUT_DTYPES", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per kernel in this process (see module docstring).
LAUNCHES = {"ivf_adc": 0, "adc_lookup": 0, "gcd_score": 0}

_FLAT_ROWS = 4096        # rows per block of the flat scan
_SMEM_LIMIT = 232_448    # shared memory one H100 block may use (bytes)
_LUT_KIND = {torch.float32: 0, torch.int8: 1, torch.uint8: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*tensors: torch.Tensor | None) -> bool:
    """True for CUDA operands, False for CPU ones; raises on mixed or other
    devices."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_scan_operands(lut, scales, codes, ids, rows: int):
    """Shared checks of the two scans; returns (b, Dp, K, lut_kind)."""
    if lut.dtype not in _LUT_KIND:
        raise TypeError(f"lut: dtype {lut.dtype}, kernel takes float32, "
                        "int8 or uint8")
    b, Dp, K = lut.shape
    _require(lut, "lut", lut.dtype, (b, Dp, K))
    kind = _LUT_KIND[lut.dtype]
    if (kind == 0) != (scales is None):
        raise ValueError("scales go with an int8/uint8 lut, and only with it")
    if scales is not None:
        _require(scales, "scales", torch.float32, (b, Dp, 2))
    _require(codes, "codes", torch.uint8, (rows, Dp))
    if ids is not None:
        _require(ids, "ids", torch.int32, (rows,))
    if K > 256:
        raise ValueError(f"K={K}: uint8 codes address at most 256 codewords")
    if 4 * Dp * K > _SMEM_LIMIT:
        raise ValueError(f"a (Dp={Dp}, K={K}) float32 LUT row does not fit "
                         "in one block's shared memory")
    return b, Dp, K, kind


def gcd_score(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A = GᵀR − RᵀG (float32, exactly antisymmetric on the card)."""
    if not _on_card(G, R):
        return ref.gcd_score_ref(G, R)
    n = R.shape[0]
    _require(G, "G", torch.float32, (n, n))
    _require(R, "R", torch.float32, (n, n))
    out = torch.empty((n, n), dtype=torch.float32, device=R.device)
    if n:
        with torch.cuda.device(R.device):
            err = _build.library().repro_gcd_score(
                _ptr(G), _ptr(R), _ptr(out), n, _stream(R.device))
        _build.check(err, "gcd_score")
        LAUNCHES["gcd_score"] += 1
    return out


def adc_lookup(lut: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor | None = None,
               ids: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ADC scores (b, Dp, K) × (N, Dp) -> (b, N) float32. ``scales``
    (b, Dp, 2): int8/uint8 LUT pack. ``ids`` (N,): rows with id < 0 score
    −inf."""
    if not _on_card(lut, codes, scales, ids):
        return ref.adc_lookup_ref(lut, codes, scales, ids)
    N = codes.shape[0]
    b, Dp, K, kind = _check_scan_operands(lut, scales, codes, ids, N)
    if b > 65535:
        raise ValueError(f"adc_lookup: b={b} exceeds the grid's y limit")
    out = torch.empty((b, N), dtype=torch.float32, device=lut.device)
    if b and N:
        with torch.cuda.device(lut.device):
            err = _build.library().repro_adc_lookup(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(ids),
                _ptr(out), b, N, Dp, K, _FLAT_ROWS, _stream(lut.device))
        _build.check(err, "adc_lookup")
        LAUNCHES["adc_lookup"] += 1
    return out


def _steps_per_block(S: int, device: torch.device) -> int:
    """Schedule steps per CUDA block of the IVF scan: enough blocks for
    about eight per SM, and at most 64 steps so a block's LUT load is
    spread over many tiles without starving the card of blocks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(64, S // (8 * sms)))


def ivf_adc(lut: torch.Tensor, codes: torch.Tensor, block_idx: torch.Tensor,
            block_query: torch.Tensor, scales: torch.Tensor | None = None,
            ids: torch.Tensor | None = None, *,
            block_size: int = 128) -> torch.Tensor:
    """Selected-block IVF-ADC scan: (b, Dp, K) LUTs × (cap, Dp) CSR codes ×
    (S,) tile schedule -> (S, block_size) float32. ``block_idx`` may repeat
    and may point at the sentinel block. ``scales``: int8/uint8 LUT pack.
    ``ids`` (cap,): rows with id < 0 score −inf."""
    if not _on_card(lut, codes, block_idx, block_query, scales, ids):
        return ref.ivf_adc_ref(lut, codes, block_idx, block_query,
                               block_size=block_size, scales=scales, ids=ids)
    cap = codes.shape[0]
    if cap % block_size:
        raise ValueError(f"cap={cap} is not a multiple of "
                         f"block_size={block_size}")
    b, Dp, K, kind = _check_scan_operands(lut, scales, codes, ids, cap)
    S = block_idx.shape[0]
    _require(block_idx, "block_idx", torch.int32, (S,))
    _require(block_query, "block_query", torch.int32, (S,))
    out = torch.empty((S, block_size), dtype=torch.float32,
                      device=lut.device)
    if S:
        with torch.cuda.device(lut.device):
            err = _build.library().repro_ivf_adc(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(block_idx),
                _ptr(block_query), _ptr(ids), _ptr(out), S, Dp, K,
                block_size, _steps_per_block(S, lut.device),
                _stream(lut.device))
        _build.check(err, "ivf_adc")
        LAUNCHES["ivf_adc"] += 1
    return out


def topk_merge(scores: torch.Tensor, ids: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, C) candidates -> (b, k) top-k under the −inf/−1 padding contract,
    equal scores ranked by ascending id. Plain torch on every device."""
    return ref.topk_merge_ref(scores, ids, k)
