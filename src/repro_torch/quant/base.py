"""Quantizer configuration (port of ``repro/quant/base.py``).

The quantizers of this port (``PQ``, ``VQ``) follow the JAX package's
Quantizer protocol: ``fit``, ``encode``, ``decode``, ``adc_tables``,
``distortion`` and ``rotate``, with ``code_width`` integer columns per item.
``PQ`` also has what the trainable index layer needs: ``encode_st`` (the
straight-through φ of Eq. 1) and ``code_dtype`` (uint8 codes for the ADC
scan).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PQConfig(NamedTuple):
    """Per-level product-quantizer shape: D subspaces × K codewords."""

    num_subspaces: int  # D
    num_codewords: int  # K

    def code_dtype(self) -> np.dtype:
        """Storage dtype of the codes: uint8 up to 256 codewords."""
        return np.dtype(np.uint8 if self.num_codewords <= 256 else np.int32)
