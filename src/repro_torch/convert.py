"""Carry index and learner state across from numpy arrays.

The port cannot import JAX, so a caller that holds a JAX-built index turns
it into numpy first (``np.asarray`` of each leaf) and hands the dict here;
both packages then serve the very same index. Storage dtypes are kept:
codes uint8 (K ≤ 256), ids and offsets int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import quant
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.rotations.gcd import GCDState

INDEX_KEYS = ("R", "centroids", "codebooks", "codes", "ids", "list_offsets",
              "block_size")


def _t(a, dev: torch.device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a, dtype=dtype))
    return torch.from_numpy(arr.copy()).to(dev)


def index_from_numpy(arrays: dict, *, device=None) -> IVFPQIndex:
    """An ``IVFPQIndex`` on ``device`` (the card by default) from the JAX
    index's arrays: keys ``R``, ``centroids``, ``codebooks``, ``codes``,
    ``ids``, ``list_offsets`` and ``block_size``."""
    missing = [k for k in INDEX_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"index_from_numpy: missing {missing}")
    dev = _device.resolve(device)
    codebooks = np.asarray(arrays["codebooks"])
    if codebooks.ndim != 3:
        raise NotImplementedError(quant.RQ_LATER)
    code_dtype = quant.PQConfig(*codebooks.shape[:2]).code_dtype()
    return IVFPQIndex(
        R=_t(arrays["R"], dev, np.float32),
        coarse=quant.VQ(_t(arrays["centroids"], dev, np.float32)),
        quantizer=quant.PQ(_t(codebooks, dev, np.float32)),
        codes=_t(arrays["codes"], dev, code_dtype),
        ids=_t(arrays["ids"], dev, np.int32),
        list_offsets=_t(arrays["list_offsets"], dev, np.int32),
        block_size=int(arrays["block_size"]))


def gcd_state_from_numpy(arrays: dict, *, device=None) -> GCDState:
    """A ``GCDState`` on ``device`` from numpy arrays: ``R`` and optionally
    ``step``. The JAX state's preconditioner accumulators ``accum`` and
    ``accum2`` may come along only as zeros (preconditioner "none", the one
    this slice ports)."""
    dev = _device.resolve(device)
    for key in ("accum", "accum2"):
        if np.any(np.asarray(arrays.get(key, 0.0))):
            raise NotImplementedError(
                f"gcd_state_from_numpy: a nonzero {key!r} belongs to a "
                "preconditioned GCD, not ported yet (ROADMAP.md queue 1, "
                "slice 2 'Training path')")
    return GCDState(R=_t(arrays["R"], dev, np.float32),
                    step=_t(arrays.get("step", 0), dev, np.int32))
