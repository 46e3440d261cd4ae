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

Two wrappers are ``torch.autograd.Function``s on both devices, because the
training path differentiates through them: ``apply_pair_rotations`` (the
backward rotates dY by −θ through the same kernel, and reduces dθ in plain
torch, as the JAX package's custom VJP does in XLA) and ``embedding_bag``
(the backward is a plain ``index_add_`` into a dense table gradient, the
gradient ``jax.grad`` of a gather gives; the JAX package has no backward
kernel for it either).
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

__all__ = ["gcd_score", "givens_rotate", "apply_pair_rotations", "pq_assign",
           "embedding_bag", "adc_lookup", "adc_batch", "ivf_adc", "fused_lut",
           "lut_column_map", "topk_merge",
           "quantize_luts", "dequantize_luts", "LUT_DTYPES", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per kernel in this process (see module docstring).
LAUNCHES = {"ivf_adc": 0, "adc_lookup": 0, "gcd_score": 0, "givens_rotate": 0,
            "pq_assign": 0, "embedding_bag": 0, "fused_lut": 0, "adc_batch": 0}

_FLAT_ROWS = 4096        # rows per block of the flat scan
_SMEM_LIMIT = 232_448    # shared memory one H100 block may use (bytes)
_LUT_KIND = {torch.float32: 0, torch.int8: 1, torch.uint8: 2}
_ROTATE_ROWS = 8         # rows per block of the plane rotation
_LUT_TILE = 32           # queries per block of the fused LUT build
_LUT_THREADS = 256       # threads per block of it (kThreads in the source)
_BATCH_ROWS = (8192, 1024)  # longest and shortest row run of a block of
#                             the grouped scan
_BATCH_TABLES = 8        # tables of a group per block (kMaxTables)


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


def givens_rotate(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                  c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """X (m, n) with column pairs (pi[l], pj[l]) rotated by cos/sin (p,):
    y_i = c·x_i + s·x_j, y_j = c·x_j − s·x_i; other columns copied. The
    pairs must be disjoint (``apply_pair_rotations`` checks it). Bit-equal
    to its plain version on the card."""
    if not _on_card(X, pi, pj, c, s):
        return ref.pair_rotate_ref(X, pi, pj, c, s)
    m, n = X.shape
    p = pi.shape[0]
    _require(X, "X", torch.float32, (m, n))
    _require(pi, "pi", torch.int32, (p,))
    _require(pj, "pj", torch.int32, (p,))
    _require(c, "c", torch.float32, (p,))
    _require(s, "s", torch.float32, (p,))
    if 12 * n > _SMEM_LIMIT:
        raise ValueError(f"givens_rotate: n={n} column map does not fit in "
                         "one block's shared memory")
    out = torch.empty_like(X)
    if m and n:
        with torch.cuda.device(X.device):
            err = _build.library().repro_givens_rotate(
                _ptr(X), _ptr(out), _ptr(pi), _ptr(pj), _ptr(c), _ptr(s), m,
                n, p, _ROTATE_ROWS, _stream(X.device))
        _build.check(err, "givens_rotate")
        LAUNCHES["givens_rotate"] += 1
    return out


def _rotate(X: torch.Tensor, pi, pj, theta: torch.Tensor) -> torch.Tensor:
    return givens_rotate(X.contiguous(), pi, pj,
                         torch.cos(theta).to(X.dtype).contiguous(),
                         torch.sin(theta).to(X.dtype).contiguous())


class _PairRotation(torch.autograd.Function):
    """Y = X·∏ℓ R_{pi[ℓ],pj[ℓ]}(θℓ) for X (m, n). The rotation is linear and
    orthogonal, so dX is dY rotated by −θ (the kernel again), and
    dθℓ = Σ_rows ⟨dY, ∂Y/∂θℓ⟩ is plane-local
    (``repro/kernels/ops.py:60-77``)."""

    @staticmethod
    def forward(ctx, X, theta, pi, pj):
        ctx.save_for_backward(X, theta, pi, pj)
        return _rotate(X, pi, pj, theta)

    @staticmethod
    def backward(ctx, dY):
        X, theta, pi, pj = ctx.saved_tensors
        dX = dtheta = None
        if ctx.needs_input_grad[0]:
            dX = _rotate(dY, pi, pj, -theta)
        if ctx.needs_input_grad[1]:
            c = torch.cos(theta).to(X.dtype)
            s = torch.sin(theta).to(X.dtype)
            pi, pj = pi.long(), pj.long()
            xe, xo = X[:, pi], X[:, pj]
            dye, dyo = dY[:, pi], dY[:, pj]
            # y_e = c·x_e + s·x_o ; y_o = c·x_o − s·x_e
            dtheta = torch.sum((dye * (-s * xe + c * xo)
                                + dyo * (-s * xo - c * xe)).float(),
                               dim=0).to(theta.dtype)
        return dX, dtheta, None, None


def _disjoint_pairs(pi: torch.Tensor, pj: torch.Tensor, n: int):
    """(pi, pj) as int32 after checking that the 2p columns are distinct
    and inside [0, n): overlapping pairs are another delta, not ported.
    Costs one host synchronisation."""
    if pi.shape != pj.shape or pi.dim() != 1:
        raise ValueError(f"pairs: pi {tuple(pi.shape)} and pj "
                         f"{tuple(pj.shape)} must be equal (p,) vectors")
    cols = torch.cat([pi, pj]).long()
    if cols.numel():
        bad = (cols.min() < 0) | (cols.max() >= n) | (torch.bincount(
            torch.clamp(cols, 0, n - 1), minlength=n).max() > 1)
        if bool(bad):
            raise ValueError(
                "apply_pair_rotations: pairs overlap or leave [0, n): the "
                "overlapping-Givens delta is not ported (ROADMAP.md slice 7)")
    return pi.to(torch.int32).contiguous(), pj.to(torch.int32).contiguous()


def apply_pair_rotations(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                         theta: torch.Tensor) -> torch.Tensor:
    """Right-multiply X (..., n) by ∏ℓ R_{pi[ℓ],pj[ℓ]}(θℓ) over disjoint
    pairs: the givens_rotate kernel on the card, its plain version on the
    CPU. Differentiable in X and θ (``_PairRotation``)."""
    n = X.shape[-1]
    pi, pj = _disjoint_pairs(pi, pj, n)
    Y = _PairRotation.apply(X.reshape(-1, n), theta, pi, pj)
    return Y.reshape(X.shape)


def pq_assign(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword assignment X (m, n) × codebooks (D, K, sub) -> (m, D)
    int32, ties to the first k. On the card a float32 SIMT kernel; it sums
    in another order than the plain einsum, so a near tie may flip."""
    if not _on_card(X, codebooks):
        return ref.pq_assign_ref(X, codebooks)
    m, n = X.shape
    D, K, sub = codebooks.shape
    if n != D * sub:
        raise ValueError(f"pq_assign: n={n} != D·sub = {D}·{sub}")
    _require(X, "X", torch.float32, (m, n))
    _require(codebooks, "codebooks", torch.float32, (D, K, sub))
    if D > 65535:
        raise ValueError(f"pq_assign: D={D} exceeds the grid's y limit")
    out = torch.empty((m, D), dtype=torch.int32, device=X.device)
    if m and D and K:
        with torch.cuda.device(X.device):
            err = _build.library().repro_pq_assign(
                _ptr(X), _ptr(codebooks), _ptr(out), m, n, D, K, sub,
                _stream(X.device))
        _build.check(err, "pq_assign")
        LAUNCHES["pq_assign"] += 1
    return out


def _embedding_bag_fwd(table, indices, bag_ids, num_bags: int, weights):
    if not _on_card(table, indices, bag_ids, weights):
        return ref.embedding_bag_ref(table, indices, bag_ids, num_bags,
                                     weights)
    V, dim = table.shape
    L = indices.shape[0]
    _require(table, "table", torch.float32, (V, dim))
    _require(indices, "indices", torch.int32, (L,))
    _require(bag_ids, "bag_ids", torch.int32, (L,))
    if weights is not None:
        _require(weights, "weights", torch.float32, (L,))
    out = torch.empty((num_bags, dim), dtype=torch.float32,
                      device=table.device)
    if num_bags and dim:
        # bag b's entries are the run [offsets[b], offsets[b + 1]) of the
        # sorted bag ids
        offsets = torch.searchsorted(
            bag_ids, torch.arange(num_bags + 1, dtype=torch.int32,
                                  device=bag_ids.device),
            out_int32=True)
        vec4 = int(dim % 4 == 0 and table.data_ptr() % 16 == 0)
        with torch.cuda.device(table.device):
            err = _build.library().repro_embedding_bag(
                _ptr(table), _ptr(indices), _ptr(offsets), _ptr(weights),
                _ptr(out), num_bags, dim, vec4, _stream(table.device))
        _build.check(err, "embedding_bag")
        LAUNCHES["embedding_bag"] += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    """EmbeddingBag(sum) with a plain backward: dTable is the dense (V, dim)
    ``index_add_`` of w·dOut[bag] over the non-padding entries, and
    dw[e] = ⟨dOut[bag[e]], table[idx[e]]⟩ (0 for padding)."""

    @staticmethod
    def forward(ctx, table, indices, bag_ids, weights, num_bags):
        ctx.save_for_backward(table, indices, bag_ids, weights)
        return _embedding_bag_fwd(table, indices, bag_ids, num_bags, weights)

    @staticmethod
    def backward(ctx, dout):
        table, indices, bag_ids, weights = ctx.saved_tensors
        valid = (indices >= 0)[:, None]
        safe = torch.clamp(indices, min=0).long()
        g = dout[bag_ids.long()]                              # (L, dim)
        dtable = dweights = None
        if ctx.needs_input_grad[0]:
            rows = g if weights is None else g * weights[:, None]
            rows = torch.where(valid, rows, torch.zeros_like(rows))
            dtable = torch.zeros_like(table).index_add_(0, safe, rows)
        if weights is not None and ctx.needs_input_grad[3]:
            dweights = torch.where(valid, g * table[safe],
                                   torch.zeros_like(g)).sum(-1)
        return dtable, None, None, dweights, None


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag(sum) -> (num_bags, dim) float32. ``indices`` (L,), −1 =
    padding (adds nothing); ``bag_ids`` (L,) sorted ascending; optional
    ``weights`` (L,). A bag with no entries is 0. Differentiable in the
    table and the weights (``_EmbeddingBag``)."""
    return _EmbeddingBag.apply(table, indices, bag_ids, weights,
                               int(num_bags))


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


def _batch_blocks(groups: int, S: int, smem: int,
                  device: torch.device) -> tuple[int, int]:
    """Rows and threads per block of the grouped scan: 512 threads, or
    1024 when a block's tables take more than half of an SM's shared
    memory (one block is all the SM then holds); runs of 8192 rows,
    halved down to 1024 while the grid would give an SM fewer than four
    blocks. Found by timing 128–1024 threads and 1024–8192 rows on an H100
    at the decode shape and Nemotron's KV geometry."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows, shortest = _BATCH_ROWS
    while rows > shortest and groups * -(-S // rows) < 4 * sms:
        rows //= 2
    return rows, 1024 if 2 * smem > _SMEM_LIMIT else 512


def adc_batch(lut: torch.Tensor, codes: torch.Tensor,
              scales: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped ADC scores (g, r, Dp, K) × (g, S, Dp) -> (g, r, S) float32,
    the KV-cache decode scorer (group = one (batch, kv-head) pair, r = the
    GQA repetition). ``scales`` (g, r, Dp, 2): int8/uint8 LUT pack. The
    uint8 codes go to the kernel as they are stored; no widened copy of the
    cache is made."""
    if not _on_card(lut, codes, scales):
        return ref.adc_batch_ref(lut, codes, scales)
    if lut.dtype not in _LUT_KIND:
        raise TypeError(f"lut: dtype {lut.dtype}, kernel takes float32, "
                        "int8 or uint8")
    g, r, Dp, K = lut.shape
    S = codes.shape[1]
    _require(lut, "lut", lut.dtype, (g, r, Dp, K))
    kind = _LUT_KIND[lut.dtype]
    if (kind == 0) != (scales is None):
        raise ValueError("scales go with an int8/uint8 lut, and only with it")
    if scales is not None:
        _require(scales, "scales", torch.float32, (g, r, Dp, 2))
    _require(codes, "codes", torch.uint8, (g, S, Dp))
    if K > 256:
        raise ValueError(f"K={K}: uint8 codes address at most 256 codewords")
    fit = min(_BATCH_TABLES, _SMEM_LIMIT // max(1, 4 * Dp * K))
    if fit < 1:
        raise ValueError(f"a (Dp={Dp}, K={K}) float32 table does not fit in "
                         "one block's shared memory")
    chunks = -(-r // fit) if r else 0
    chunk = -(-r // chunks) if r else 1
    if g * chunks > 65535:
        raise ValueError(f"adc_batch: {g} groups × {chunks} table chunks "
                         "exceed the grid's y limit")
    if -(-S // _BATCH_ROWS[1]) > 2**31 - 1:
        raise ValueError(f"adc_batch: S={S} exceeds the grid's x limit")
    out = torch.empty((g, r, S), dtype=torch.float32, device=lut.device)
    if g and r and S:
        rows, threads = _batch_blocks(g * chunks, S, 4 * chunk * Dp * K,
                                      lut.device)
        with torch.cuda.device(lut.device):
            err = _build.library().repro_adc_batch(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(out), g, r,
                S, Dp, K, chunk, rows, threads, _stream(lut.device))
        _build.check(err, "adc_batch")
        LAUNCHES["adc_batch"] += 1
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


def lut_column_map(colmap: torch.Tensor) -> torch.Tensor:
    """The (Dp,) int32 code column -> query subspace map of a one-hot
    (Dp, D) ``colmap``, as the fused_lut kernel takes it. Raises unless
    every row is one-hot; that check costs one host synchronisation, so
    callers make the map once per state, not per batch."""
    if colmap.dim() != 2:
        raise ValueError(f"colmap: shape {tuple(colmap.shape)}, expected "
                         "(Dp, D)")
    one = (colmap == 1).sum(dim=1) == 1
    zero = ((colmap == 0) | (colmap == 1)).all(dim=1)
    if not bool((one & zero).all()):
        raise ValueError("colmap must be one-hot: each code column reads "
                         "exactly one query subspace")
    return colmap.argmax(dim=1).to(torch.int32).contiguous()


def fused_lut(Q: torch.Tensor, qdelta: torch.Tensor, cb_flat: torch.Tensor,
              colmap: torch.Tensor, *,
              cols: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation-fused ADC tables: queries (b, n) × query-side transform
    (n, n) × frozen flattened codebooks (Dp, K, sub) × one-hot column map
    (Dp, D) -> (b, Dp, K) float32 with
    lut[b, p, k] = ⟨(Q·qdelta) subspace of column p, cb_flat[p, k]⟩.
    ``cols`` is ``lut_column_map(colmap)``, made once by the caller; the
    card's kernel reads it in place of the one-hot matrix (made here, with
    a host synchronisation, when it is not given). On the card the
    subspace width must be 4, 8 or 16 and ``cb_flat`` 16-byte aligned."""
    if not _on_card(Q, qdelta, cb_flat, colmap, cols):
        return ref.fused_lut_ref(Q, qdelta, cb_flat, colmap)
    b, n = Q.shape
    Dp, K, sub = cb_flat.shape
    D = colmap.shape[1]
    if D * sub != n:
        raise ValueError(f"fused_lut: n={n} != D·sub = {D}·{sub}")
    _require(Q, "Q", torch.float32, (b, n))
    _require(qdelta, "qdelta", torch.float32, (n, n))
    _require(cb_flat, "cb_flat", torch.float32, (Dp, K, sub))
    if cols is None:
        cols = lut_column_map(colmap)
    _require(cols, "cols", torch.int32, (Dp,))
    if sub not in (4, 8, 16):
        raise ValueError(f"fused_lut: the kernel takes subspaces of 4, 8 or "
                         f"16 columns, not {sub}")
    if cb_flat.data_ptr() % 16:
        raise ValueError("fused_lut: cb_flat must be 16-byte aligned")
    parts = _LUT_THREADS // _LUT_TILE
    smem = 4 * (n * sub + (1 + parts) * _LUT_TILE * sub)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_lut: a tile of {_LUT_TILE} queries at n={n} "
                         f"and sub={sub} needs {smem} bytes of shared memory, "
                         "more than one block has")
    if Dp > 65535:
        raise ValueError(f"fused_lut: Dp={Dp} exceeds the grid's y limit")
    out = torch.empty((b, Dp, K), dtype=torch.float32, device=Q.device)
    if b and Dp and K:
        with torch.cuda.device(Q.device):
            err = _build.library().repro_fused_lut(
                _ptr(Q), _ptr(qdelta), _ptr(cb_flat), _ptr(cols), _ptr(out),
                b, n, Dp, K, sub, _LUT_TILE, _stream(Q.device))
        _build.check(err, "fused_lut")
        LAUNCHES["fused_lut"] += 1
    return out


def topk_merge(scores: torch.Tensor, ids: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, C) candidates -> (b, k) top-k under the −inf/−1 padding contract,
    equal scores ranked by ascending id. Plain torch on every device."""
    return ref.topk_merge_ref(scores, ids, k)
