"""The port's plain kernel versions (``repro_torch.kernels``) against the JAX
package's kernels, on the CPU.

The same numpy-seeded inputs go through both. The JAX side calls its Pallas
kernels as tests/test_kernels.py does (interpret mode off a TPU), so the
shapes stay tiny; the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances: ``gcd_score`` to 1e-5 (one float32 product of n terms); the
scans to atol 1e-4, rtol 1e-5, since the Dp float32 terms are summed in
another order; their −inf positions exactly. ``pq_assign`` exactly, on
dyadic inputs whose scores are exact in float32, ties and all;
``embedding_bag`` to 1e-5; ``apply_pair_rotations`` and its gradients to
1e-6.
"""
from __future__ import annotations

import jax
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
    """The plain version of the givens_rotate kernel over a full X with an
    unpaired column against the JAX Pallas kernel (interpret mode) on the
    gathered planes, 1e-6; the unpaired column is copied exactly."""
    from repro.kernels import givens_rotate as jrot

    rng = np.random.RandomState(3)
    X = rng.randn(7, 11).astype(np.float32)
    perm = rng.permutation(11)
    pi, pj = perm[:5], perm[5:10]
    c, s = (rng.randn(5).astype(np.float32) for _ in range(2))
    ye, yo = jrot.givens_rotate(*map(jnp.asarray, (X[:, pi], X[:, pj], c, s)))
    got = tref.pair_rotate_ref(*map(_t, (X, pi, pj, c, s))).numpy()
    np.testing.assert_allclose(got[:, pi], np.asarray(ye), atol=1e-6)
    np.testing.assert_allclose(got[:, pj], np.asarray(yo), atol=1e-6)
    np.testing.assert_array_equal(got[:, perm[10]], X[:, perm[10]])


def test_wrappers_refuse_other_devices():
    """Operands on a device that is neither the CPU nor the card, or on
    several devices, get no kernel and no plain version: the call raises."""
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        tops.gcd_score(meta, meta)
    with pytest.raises(ValueError):
        tops.gcd_score(torch.zeros((4, 4)), meta)
    with pytest.raises(ValueError):
        tops.pq_assign(meta, torch.zeros((2, 3, 2)))
    with pytest.raises(ValueError):
        tops.givens_rotate(meta, *(torch.zeros(1),) * 4)


def _dyadic(rng: np.random.RandomState, *shape) -> np.ndarray:
    """Quarter-integers in [−2, 2]: every product and short sum of them is
    exact in float32, so the JAX package and the port compute the same
    scores whatever their summation order, and ties are real ties."""
    return (rng.randint(-8, 9, size=shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("m,D,K,sub", [(40, 4, 16, 2), (33, 1, 64, 8),
                                       (7, 8, 32, 8)])
def test_pq_assign_ref_matches_jax(m, D, K, sub):
    """Equal codes, first index on ties, against the JAX oracle and its
    Pallas kernel (interpret mode)."""
    rng = np.random.RandomState(m + K)
    X = _dyadic(rng, m, D * sub)
    C = _dyadic(rng, D, K, sub)
    want = np.asarray(jref.pq_assign_ref(jnp.asarray(X), jnp.asarray(C)))
    got = tops.pq_assign(_t(X), _t(C))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.pq_assign_ref(_t(X), _t(C)).numpy(),
                                  want)
    kern = np.asarray(jops.pq_assign(jnp.asarray(X), jnp.asarray(C)))
    np.testing.assert_array_equal(got.numpy(), kern)


def test_pq_assign_ties_go_to_the_first_codeword():
    X = np.zeros((3, 4), np.float32)
    C = np.zeros((2, 5, 2), np.float32)
    C[:, 3] = 0.0                   # all five codewords tie at distance 0
    got = tops.pq_assign(_t(X), _t(C))
    np.testing.assert_array_equal(got.numpy(), np.zeros((3, 2), np.int32))


def _bag_inputs(rng: np.random.RandomState, V=50, dim=12, bags=9, L=40):
    table = rng.randn(V, dim).astype(np.float32)
    idx = rng.randint(0, V, size=L).astype(np.int32)
    idx[rng.rand(L) < 0.3] = -1                       # padding
    bag = np.sort(rng.randint(0, bags, size=L)).astype(np.int32)
    bag[bag == 4] = 5                                 # bag 4 is empty
    idx[bag == 2] = -1                                # bag 2 is all padding
    w = rng.randn(L).astype(np.float32)
    return table, idx, np.sort(bag), w, bags


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax_kernel(weighted):
    """−1 padding adds nothing and a bag with no entries is 0, as the JAX
    package's kernel wrapper gives them (interpret mode), to 1e-5."""
    table, idx, bag, w, bags = _bag_inputs(np.random.RandomState(5))
    w = w if weighted else None
    want = np.asarray(jops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), bags,
        None if w is None else jnp.asarray(w)))
    got = tops.embedding_bag(_t(table), _t(idx), _t(bag), bags,
                             None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not np.any(got.numpy()[[2, 4]])            # exact zeros
    plain = tref.embedding_bag_ref(_t(table), _t(idx), _t(bag), bags,
                                   None if w is None else _t(w))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_embedding_bag_gradient_matches_jax():
    """The plain backward: dense dTable and dw against ``jax.grad`` of the
    masked take-and-segment-sum the JAX package differentiates, 1e-5."""
    table, idx, bag, w, bags = _bag_inputs(np.random.RandomState(6))
    dout = np.random.RandomState(7).randn(bags, table.shape[1]).astype(
        np.float32)

    def jloss(tb, wt):
        rows = jnp.take(tb, jnp.maximum(idx, 0), axis=0) * wt[:, None]
        rows = jnp.where((idx >= 0)[:, None], rows, 0.0)
        out = jax.ops.segment_sum(rows, bag, num_segments=bags)
        return jnp.sum(out * dout)

    want_t, want_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                      jnp.asarray(w))
    tt = _t(table).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    out = tops.embedding_bag(tt, _t(idx), _t(bag), bags, tw)
    got_t, got_w = torch.autograd.grad(out, (tt, tw), _t(dout))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)


@pytest.mark.parametrize("m,n,p", [(6, 8, 4), (5, 11, 3), (1, 2, 1)])
def test_apply_pair_rotations_grad_matches_jax(m, n, p):
    """Forward, dX and dθ of the port's autograd.Function against
    ``jax.grad`` through the JAX custom VJP (plain path), 1e-6. Ragged n
    leaves columns unpaired."""
    rng = np.random.RandomState(m * n)
    X = rng.randn(m, n).astype(np.float32)
    perm = rng.permutation(n)
    pi, pj = perm[:p].astype(np.int32), perm[p:2 * p].astype(np.int32)
    theta = rng.randn(p).astype(np.float32)
    dY = rng.randn(m, n).astype(np.float32)

    def jloss(x, th):
        y = jops.apply_pair_rotations(x, jnp.asarray(pi), jnp.asarray(pj),
                                      th, use_kernel=False)
        return jnp.sum(y * dY), y

    (_, want_y), (want_dx, want_dth) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(X),
                                             jnp.asarray(theta))
    tx = _t(X).requires_grad_(True)
    tth = _t(theta).requires_grad_(True)
    y = tops.apply_pair_rotations(tx, _t(pi), _t(pj), tth)
    got_dx, got_dth = torch.autograd.grad(y, (tx, tth), _t(dY))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_dth.numpy(), np.asarray(want_dth),
                               atol=1e-6, rtol=1e-6)


def test_apply_pair_rotations_matches_its_plain_autograd():
    """The hand-written backward equals torch.autograd of the plain
    version: dX bit for bit (the chip check holds the kernel to the same)."""
    rng = np.random.RandomState(9)
    X = _t(rng.randn(7, 10).astype(np.float32)).requires_grad_(True)
    th = _t(rng.randn(4).astype(np.float32)).requires_grad_(True)
    pi, pj = torch.tensor([0, 2, 9, 5]), torch.tensor([1, 7, 3, 6])
    dY = _t(rng.randn(7, 10).astype(np.float32))
    a = torch.autograd.grad(tops.apply_pair_rotations(X, pi, pj, th),
                            (X, th), dY)
    b = torch.autograd.grad(tref.apply_pair_rotations_ref(X, pi, pj, th),
                            (X, th), dY)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pi,pj", [([0, 1], [1, 2]), ([0, 3], [4, 0]),
                                   ([0], [9])])
def test_apply_pair_rotations_rejects_overlap(pi, pj):
    """Overlapping pairs are another delta (not ported); out-of-range ones
    are an error."""
    X = torch.zeros((2, 6))
    with pytest.raises(ValueError):
        tops.apply_pair_rotations(X, torch.tensor(pi), torch.tensor(pj),
                                  torch.zeros(len(pi)))


def _fused_lut_operands(seed: int, b: int, n: int, Dp: int, K: int, sub: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n).astype(np.float32),
            rng.randn(n, n).astype(np.float32),
            rng.randn(Dp, K, sub).astype(np.float32))


def _rq_colmap(D: int, M: int) -> np.ndarray:
    """The level-major depth-M RQ column map of ``repro/quant/rq.py``
    ``lut_operands``, built by hand: column l·D+d reads subspace d."""
    cols = np.arange(M * D)
    return np.eye(D, dtype=np.float32)[cols % D]


# b, n, D, K, sub, depth: the PQ shapes of tests/test_kernels.py and its
# depth-2 RQ layout
FUSED_LUT_CASES = [(3, 16, 4, 8, 4, 1), (17, 32, 8, 16, 4, 1),
                   (5, 16, 4, 8, 4, 2)]


@pytest.mark.parametrize("b,n,D,K,sub,depth", FUSED_LUT_CASES)
def test_fused_lut_matches_jax_kernel(b, n, D, K, sub, depth):
    """The plain version against the JAX Pallas kernel (interpret mode) and
    against the two-step form Q·qdelta, then one einsum per code column;
    atol = rtol = 1e-5 (float32 sums of n and sub terms)."""
    Q, qd, cb = _fused_lut_operands(b, b, n, depth * D, K, sub)
    colmap = _rq_colmap(D, depth)
    want = np.asarray(jops.fused_lut(jnp.asarray(Q), jnp.asarray(qd),
                                     jnp.asarray(cb), jnp.asarray(colmap)))
    before = dict(tops.LAUNCHES)
    got = tops.fused_lut(_t(Q), _t(qd), _t(cb), _t(colmap))
    assert tops.LAUNCHES == before          # a CPU call launches nothing
    assert got.dtype == torch.float32 and got.shape == (b, depth * D, K)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    QL = (Q.astype(np.float64) @ qd).reshape(b, D, sub)
    for p in range(depth * D):
        direct = np.einsum("bs,ks->bk", QL[:, p % D], cb[p])
        np.testing.assert_allclose(got[:, p].numpy(), direct, atol=1e-5,
                                   rtol=1e-5)


def test_lut_column_maps_are_one_hot():
    """The kernel reads an integer column map: PQ's identity and the RQ
    level-major layout are one-hot and map as the einsum does; a map that
    is not one-hot is refused."""
    from repro_torch import quant

    cb = torch.zeros((4, 8, 2))
    _, eye = quant.PQ(cb).lut_operands()
    assert torch.equal(eye, torch.eye(4))
    np.testing.assert_array_equal(tops.lut_column_map(eye).numpy(),
                                  np.arange(4))
    rq = tops.lut_column_map(_t(_rq_colmap(4, 2)))
    assert rq.dtype == torch.int32
    np.testing.assert_array_equal(rq.numpy(), np.arange(8) % 4)
    for bad in (torch.zeros((4, 4)), 2.0 * torch.eye(4),
                torch.ones((4, 4)), torch.eye(4)[:, :, None]):
        with pytest.raises(ValueError):
            tops.lut_column_map(bad)
