"""The port's plain kernel versions (``repro_torch.kernels``) against the JAX
package's kernels, on the CPU.

The same numpy-seeded inputs go through both. The JAX side calls its Pallas
kernels as tests/test_kernels.py does (interpret mode off a TPU), so the
shapes stay tiny; the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances: ``gcd_score`` to 1e-5 (one float32 product of n terms); the
scans to atol 1e-4, rtol 1e-5, since the Dp float32 terms are summed in
another order; their −inf positions exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import search as jsearch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.index import search as tsearch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-5


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))        # a writable copy


def _assert_scores(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=SCAN_ATOL,
                               rtol=SCAN_RTOL)


def _lut_pack(rng: np.random.RandomState, shape, lut_dtype: str):
    """A (lut, scales) pair in the JAX package's packing, as numpy."""
    lut = rng.randn(*shape).astype(np.float32)
    if lut_dtype == "float32":
        return lut, None
    qlut, scales = jops.quantize_luts(jnp.asarray(lut), lut_dtype)
    return np.asarray(qlut), np.asarray(scales)


def _pair(a):
    return (None, None) if a is None else (jnp.asarray(a), _t(a))


@pytest.mark.parametrize("n", [32, 64, 256])
def test_gcd_score_matches_jax_kernel(n):
    rng = np.random.RandomState(n)
    G = rng.randn(n, n).astype(np.float32)
    R = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
    want = np.asarray(jops.gcd_score(jnp.asarray(G), jnp.asarray(R)))
    got = tops.gcd_score(_t(G), _t(R))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy(), -got.numpy().T)
    np.testing.assert_allclose(
        tref.gcd_score_ref(_t(G), _t(R)).numpy(),
        np.asarray(jref.gcd_score_ref(jnp.asarray(G), jnp.asarray(R))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lut_dtype", ["float32", "int8", "uint8"])
def test_adc_lookup_matches_jax_kernel(lut_dtype, masked):
    rng = np.random.RandomState(11 + masked)
    b, N, Dp, K = 3, 2000, 8, 16
    lut, scales = _lut_pack(rng, (b, Dp, K), lut_dtype)
    codes = rng.randint(0, K, size=(N, Dp)).astype(np.uint8)
    ids = np.where(rng.rand(N) < 0.3, -1, np.arange(N)).astype(np.int32)
    ids = ids if masked else None
    j_scales, t_scales = _pair(scales)
    j_ids, t_ids = _pair(ids)
    want = jops.adc_lookup(jnp.asarray(lut), jnp.asarray(codes), j_scales,
                           j_ids)
    got = tops.adc_lookup(_t(lut), _t(codes), t_scales, t_ids)
    _assert_scores(got, want)
    if masked:
        assert np.all(np.isneginf(got.numpy()[:, ids < 0]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lut_dtype", ["float32", "int8", "uint8"])
def test_ivf_adc_matches_jax_kernel(lut_dtype, masked):
    """A schedule with repeated tiles, sentinel tiles and queries that come
    back after others, as the CUDA body's LUT reload must handle."""
    rng = np.random.RandomState(21 + masked)
    b, Dp, K, bs, nblocks, S = 4, 8, 16, 16, 10, 40
    lut, scales = _lut_pack(rng, (b, Dp, K), lut_dtype)
    cap = nblocks * bs
    codes = rng.randint(0, K, size=(cap, Dp)).astype(np.uint8)
    ids = np.where(rng.rand(cap) < 0.3, -1, np.arange(cap)).astype(np.int32)
    ids[-bs:] = -1                                     # sentinel block
    ids = ids if masked else None
    block_idx = rng.randint(0, nblocks, size=S).astype(np.int32)
    block_idx[::7] = nblocks - 1
    block_query = np.sort(rng.randint(0, b, size=S)).astype(np.int32)
    block_query[-5:] = 0                               # a query returns
    j_scales, t_scales = _pair(scales)
    j_ids, t_ids = _pair(ids)
    want = jops.ivf_adc(jnp.asarray(lut), jnp.asarray(codes),
                        jnp.asarray(block_idx), jnp.asarray(block_query),
                        j_scales, j_ids, block_size=bs)
    got = tops.ivf_adc(_t(lut), _t(codes), _t(block_idx), _t(block_query),
                       t_scales, t_ids, block_size=bs)
    _assert_scores(got, want)


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_quantize_luts_matches_jax(dtype):
    rng = np.random.RandomState(5)
    lut = rng.randn(4, 8, 16).astype(np.float32)
    lut[:, 3, :] = 0.0                        # constant column: scale 1
    lut[1, 5, :] = 2.5
    want_q, want_s = jops.quantize_luts(jnp.asarray(lut), dtype)
    got_q, got_s = tops.quantize_luts(_t(lut), dtype)
    assert got_q.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        tops.dequantize_luts(got_q, got_s).numpy(),
        np.asarray(jops.dequantize_luts(want_q, want_s)), atol=1e-6, rtol=0)


def test_quantize_luts_rejects_other_dtypes():
    with pytest.raises(ValueError):
        tops.quantize_luts(torch.zeros((1, 2, 4)), "float16")


def _tied_candidates(rng, b, C):
    scores = rng.choice([3.0, 2.0, 1.0, 0.5, -np.inf],
                        size=(b, C)).astype(np.float32)
    ids = np.stack([rng.permutation(C) for _ in range(b)]).astype(np.int32)
    ids = np.where(np.isfinite(scores), ids, -1).astype(np.int32)
    return scores, ids


@pytest.mark.parametrize("k", [1, 8, 40])
def test_topk_merge_matches_jax_on_ties(k):
    rng = np.random.RandomState(k)
    scores, ids = _tied_candidates(rng, 5, 24)
    scores[4] = -np.inf                        # a row with no candidate
    ids[4] = -1
    want_s, want_i = jops.topk_merge(jnp.asarray(scores), jnp.asarray(ids), k)
    got_s, got_i = tops.topk_merge(_t(scores), _t(ids), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [3, 10, 600])
def test_topk_padded_prefilter_matches_jax(k):
    """The port keeps only the candidates that can reach the top-k before
    the two-key sort; the result must equal the JAX full sort exactly,
    ties and padding included."""
    rng = np.random.RandomState(100 + k)
    scores, ids = _tied_candidates(rng, 4, 512)
    scores[1, 50:] = -np.inf                   # fewer finite than k
    ids[1, 50:] = -1
    for cand_ids in (ids, ids[0]):
        want_s, want_i = jsearch.topk_padded(jnp.asarray(scores),
                                             jnp.asarray(cand_ids), k)
        got_s, got_i = tsearch.topk_padded(_t(scores), _t(cand_ids), k)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_givens_rotate_ref_matches_jax():
    rng = np.random.RandomState(3)
    xe, xo = (rng.randn(7, 5).astype(np.float32) for _ in range(2))
    c, s = (rng.randn(5).astype(np.float32) for _ in range(2))
    want = jref.givens_rotate_ref(*map(jnp.asarray, (xe, xo, c, s)))
    got = tref.givens_rotate_ref(*map(_t, (xe, xo, c, s)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_wrappers_refuse_other_devices():
    """Operands on a device that is neither the CPU nor the card, or on
    several devices, get no kernel and no plain version: the call raises."""
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        tops.gcd_score(meta, meta)
    with pytest.raises(ValueError):
        tops.gcd_score(torch.zeros((4, 4)), meta)
