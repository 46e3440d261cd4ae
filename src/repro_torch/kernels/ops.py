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
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.adc_common import (  # noqa: F401
    LUT_DTYPES,
    dequantize_luts,
    quantize_luts,
)

__all__ = ["gcd_score", "gcd_score_tile", "givens_rotate",
           "givens_rotate_plan", "apply_pair_rotations", "pq_assign",
           "pq_assign_plan", "embedding_bag", "adc_lookup",
           "adc_lookup_plan", "adc_batch", "adc_batch_plan", "ivf_adc",
           "ivf_adc_plan",
           "ivf_adc_run_starts", "fused_lut", "fused_lut_plan",
           "lut_column_map", "topk_merge", "quantize_luts",
           "dequantize_luts", "LUT_DTYPES", "LAUNCHES", "reset_launches"]

#: Kernel launches per kernel in this process (see module docstring).
LAUNCHES = {"ivf_adc": 0, "adc_lookup": 0, "gcd_score": 0, "givens_rotate": 0,
            "pq_assign": 0, "embedding_bag": 0, "fused_lut": 0, "adc_batch": 0}

_SMEM_LIMIT = 232_448    # shared memory one H100 block may use (bytes)
_SM_SMEM = 233_472       # shared memory of one H100 SM (bytes)
_SM_THREADS = 2048       # resident threads of one SM
_BLOCK_SMEM = 1024       # shared memory the card reserves for each block
_IVF_THREADS = 512       # threads per block of the IVF scan (kIvfThreads)
_IVF_BLOCKS = 3          # of them an SM holds (kIvfMinBlocks, registers)
_IVF_WINDOW = 256        # schedule steps a block holds at once (kIvfWindow)
_IVF_WAVES = 4           # resident waves of blocks the IVF scan's grid fills
_IVF_MIN_PASSES = 2      # passes of a block over its run, at least
_FLAT_RC = (4, 2, 1)     # queries per block of the flat scan, widest first
_FLAT_WAVES = 4          # resident waves of blocks of the flat scan's grid
_FLAT_MIN_ROWS = 4       # code rows per thread of a flat-scan block, least
_LUT_KIND = {torch.float32: 0, torch.int8: 1, torch.uint8: 2}
_ROTATE_THREADS = 256    # threads per block of the plane rotation, most
_ROTATE_WAVES = 1        # blocks per SM its grid has, at least
_ROTATE_RUN_BYTES = 8192  # bytes of X one block of it stages, most
_LUT_TILES = (32, 16, 8, 4, 2, 1)  # query tiles of the fused LUT build
_LUT_THREADS = 256       # threads per block of it (kThreads in the source)
_LUT_RUN_LEN = 16        # inputs per run of its rotation's sums
_LUT_FILL = 0.9          # blocks per SM its grid has, at least
_BATCH_WAVES = 2         # resident waves of blocks of the grouped scan's
#                          grid
_BATCH_MIN_ROWS = 2      # code rows per thread of a grouped-scan block, least
_BATCH_THREADS = 512     # threads per block of it, unless below
_BATCH_WIDE_TABLES = 5   # chunks of up to this many float32 tables run
#                          in 32 registers a thread (kBatchWideTables)
_BATCH_MAX_TABLES = 12   # tables of a group one block stages, most
#                          (kBatchMaxTables)
#: expected shared-memory wavefronts of one warp's lookup into a plane of
#: w interleaved tables on uniform codes (K = 256): per phase of 32 / w
#: lanes, the most distinct entries one of its 32 / w bank units serves
_PLANE_WAVEFRONTS = {4: 10.17, 2: 5.84, 1: 3.16}
_GCD_TILES = (16, 32)    # gcd_score tile widths, narrow and wide
_GCD_WIDE = 256          # the widest n that takes the narrow tiles
_ASSIGN_RESIDENT_SUB = 16   # widest subvector of the resident pq_assign body
_ASSIGN_THREADS = 256    # threads per block of either pq_assign body
_ASSIGN_BODY = {"resident": 0, "tiled": 1, "streamed": 2}
_ASSIGN_TILE_CODES = 128  # codewords per tile of the tiled body (kTileCodes)
_ASSIGN_LDC = 36         # padded 32-column slab row of it (kLdc)


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


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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


def gcd_score_tile(n: int) -> int:
    """Tile width of the gcd_score kernel at n: 16 up to n = 256 and 32
    above, so n = 256 and n = 512 both give 136 tile pairs I ≤ J (one block
    each) for the card's 132 SMs. The source owns the rest of the launch."""
    return _GCD_TILES[0] if n <= _GCD_WIDE else _GCD_TILES[1]


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
                _ptr(G), _ptr(R), _ptr(out), n, gcd_score_tile(n),
                _stream(R.device))
        _build.check(err, "gcd_score")
        LAUNCHES["gcd_score"] += 1
    return out


def givens_rotate_plan(m: int, n: int, sms: int) -> dict:
    """Launch plan of the givens_rotate kernel for X (m, n) on a card with
    ``sms`` SMs: each block stages a run of ``rows`` whole rows in shared
    memory, as many as still give the grid ``_ROTATE_WAVES`` blocks an SM
    (one row a block at (256, 256), three at (512, 512)) and no more than
    ``_ROTATE_RUN_BYTES`` of X (8 rows at (8192, 256)), with one thread per
    four columns of the run up to ``_ROTATE_THREADS``. Each block builds
    the column map anew, so fewer, longer runs win where the card is
    filled (``kernel_bench.py --sweep`` times other values of the
    constants). ``smem`` is the column map (12 bytes a column) and the
    run, which the kernel's entry checks against its own count."""
    rows = max(1, min(m // (_ROTATE_WAVES * sms),
                      _ROTATE_RUN_BYTES // (4 * max(n, 1))))
    threads = min(_ROTATE_THREADS, max(32, -(-rows * -(-n // 4) // 32) * 32))
    return dict(rows=rows, threads=threads, smem=12 * n + 4 * rows * n,
                blocks=-(-m // rows))


def givens_rotate(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                  c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """X (m, n) with column pairs (pi[l], pj[l]) rotated by cos/sin (p,):
    y_i = c·x_i + s·x_j, y_j = c·x_j − s·x_i; other columns copied. The
    pairs must be disjoint (``apply_pair_rotations`` checks it). Bit-equal
    to its plain version on the card (``givens_rotate_plan``)."""
    if not _on_card(X, pi, pj, c, s):
        return ref.pair_rotate_ref(X, pi, pj, c, s)
    m, n = X.shape
    p = pi.shape[0]
    _require(X, "X", torch.float32, (m, n))
    _require(pi, "pi", torch.int32, (p,))
    _require(pj, "pj", torch.int32, (p,))
    _require(c, "c", torch.float32, (p,))
    _require(s, "s", torch.float32, (p,))
    if 16 * n > _SMEM_LIMIT:
        raise ValueError(f"givens_rotate: n={n}: the column map and one row "
                         "do not fit in one block's shared memory")
    out = torch.empty_like(X)
    if m and n:
        plan = givens_rotate_plan(m, n, _sms(X.device))
        if plan["blocks"] > 2**31 - 1:
            raise ValueError(f"givens_rotate: {plan['blocks']} blocks exceed "
                             "the grid's x limit")
        with torch.cuda.device(X.device):
            err = _build.library().repro_givens_rotate(
                _ptr(X), _ptr(out), _ptr(pi), _ptr(pj), _ptr(c), _ptr(s), m,
                n, p, plan["rows"], plan["threads"], plan["smem"],
                _stream(X.device))
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
    and inside [0, n): overlapping pairs are another delta
    (``rotations.GivensDelta(overlapping=True)``, applied pair after pair
    in plain PyTorch). Costs one host synchronisation."""
    if pi.shape != pj.shape or pi.dim() != 1:
        raise ValueError(f"pairs: pi {tuple(pi.shape)} and pj "
                         f"{tuple(pj.shape)} must be equal (p,) vectors")
    cols = torch.cat([pi, pj]).long()
    if cols.numel():
        bad = (cols.min() < 0) | (cols.max() >= n) | (torch.bincount(
            torch.clamp(cols, 0, n - 1), minlength=n).max() > 1)
        if bool(bad):
            raise ValueError(
                "apply_pair_rotations: pairs overlap or leave [0, n); "
                "overlapping pairs go through GivensDelta(overlapping=True)")
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


def pq_assign_plan(m: int, D: int, K: int, sub: int, sms: int) -> dict:
    """Launch plan of the pq_assign kernel for X (m, D·sub) × codebooks
    (D, K, sub) on a card with ``sms`` SMs; every block has 256 threads.

    ``resident`` (sub ≤ 16, the codebook and its norms fit in shared
    memory): 8 rows a thread; while the grid would give the card fewer
    than two blocks per SM, rows per thread halve down to 1, then each row
    gets 2, 4, … up to 32 lanes (``split``) that share its codewords (a
    decode step's 16 rows: 32 blocks of 8 rows, each row's 32 lanes taking
    8 codewords). ``tiled`` otherwise: 16·rows_per_thread rows a block
    kept in shared memory, the most rows (8, 4, 2, 1) whose tile fits;
    ``streamed`` where not even 16 rows fit (sub above about 3,000): 128
    rows a block, streamed a 32-column slab at a time. The grid is D × row
    blocks, flattened. ``smem`` is the layout's shared memory, which the
    kernel's entry checks against its own."""
    sp = -(-sub // 4) * 4
    ld = sp if (sp // 4) % 2 else sp + 4    # resident_ld: padded row
    if sub <= _ASSIGN_RESIDENT_SUB and 4 * K * (ld + 1) <= _SMEM_LIMIT:
        rpt, split = 8, 1

        def blocks():
            return D * -(-m // (_ASSIGN_THREADS // split * rpt))

        while blocks() < 2 * sms and (rpt > 1 or 2 * split <= min(32, K)):
            if rpt > 1:
                rpt //= 2
            else:
                split *= 2
        return dict(body="resident", threads=_ASSIGN_THREADS,
                    rows_per_thread=rpt, split=split,
                    rows=_ASSIGN_THREADS // split * rpt, blocks=blocks(),
                    smem=4 * K * (ld + 1))
    ring = 2 * _ASSIGN_TILE_CODES * _ASSIGN_LDC + _ASSIGN_THREADS
    body, rm = "streamed", 8
    for r in (8, 4, 2, 1):
        if 4 * (16 * r * (sp + 4) + ring) <= _SMEM_LIMIT:
            body, rm = "tiled", r
            break
    xs = 16 * rm * (sp + 4) if body == "tiled" else 2 * 16 * rm * _ASSIGN_LDC
    return dict(body=body, threads=_ASSIGN_THREADS, rows_per_thread=rm,
                split=16, rows=16 * rm, blocks=D * -(-m // (16 * rm)),
                smem=4 * (xs + ring))


def pq_assign(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword assignment X (m, n) × codebooks (D, K, sub) -> (m, D)
    int32, ties to the first k. On the card a float32 SIMT kernel, one of
    two bodies by ``pq_assign_plan``; it sums in another order than the
    plain einsum, so a near tie may flip."""
    if not _on_card(X, codebooks):
        return ref.pq_assign_ref(X, codebooks)
    m, n = X.shape
    D, K, sub = codebooks.shape
    if n != D * sub:
        raise ValueError(f"pq_assign: n={n} != D·sub = {D}·{sub}")
    _require(X, "X", torch.float32, (m, n))
    _require(codebooks, "codebooks", torch.float32, (D, K, sub))
    out = torch.empty((m, D), dtype=torch.int32, device=X.device)
    if m and D and K:
        sms = torch.cuda.get_device_properties(
            X.device).multi_processor_count
        plan = pq_assign_plan(m, D, K, sub, sms)
        if plan["blocks"] > 2**31 - 1:
            raise ValueError(f"pq_assign: {plan['blocks']} blocks exceed the "
                             "grid's x limit")
        with torch.cuda.device(X.device):
            err = _build.library().repro_pq_assign(
                _ptr(X), _ptr(codebooks), _ptr(out), m, n, D, K, sub,
                _ASSIGN_BODY[plan["body"]], plan["threads"],
                plan["rows_per_thread"],
                plan["split"] if plan["body"] == "resident" else 1,
                plan["smem"], _stream(X.device))
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


def _resident(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that one SM holds at once (registers aside)."""
    return max(1, min(_SM_THREADS // threads,
                      _SM_SMEM // (smem + _BLOCK_SMEM)))


def adc_lookup_plan(b: int, N: int, Dp: int, K: int, sms: int) -> dict:
    """Launch plan of the flat scan of b (Dp, K) tables over N code rows on
    a card with ``sms`` SMs.

    A block stages ``rc`` queries' tables, interleaved (entry (d, k) of four
    queries in one float4), and scores each code row it reads against all
    of them: rc = 4 from b = 3 up where four float32 tables fit in shared
    memory, else 2, else 1 (Dp = 64, K = 256: 2), and b itself below 3.
    The last of the ``chunks`` = ⌈b / rc⌉ chunks may be partial. Blocks of
    1024 threads where one block fills an SM's shared memory, else 512;
    each takes a run of ``rows`` code rows (a multiple of its threads, at
    least ``_FLAT_MIN_ROWS`` a thread), cut so that the grid of chunks × row
    runs is about ``_FLAT_WAVES`` resident waves (``kernel_bench.py
    --sweep`` times the alternatives)."""
    fits = [rc for rc in _FLAT_RC if 4 * rc * Dp * K <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"a (Dp={Dp}, K={K}) float32 table does not fit in "
                         "one block's shared memory")
    rc = next(r for r in fits if r <= (4 if b >= 3 else max(b, 1)))
    smem = 4 * rc * Dp * K
    threads = 1024 if 2 * (smem + _BLOCK_SMEM) > _SM_SMEM else 512
    chunks = -(-b // rc)
    runs = max(1, -(-_FLAT_WAVES * sms * _resident(threads, smem) // chunks))
    rows = -(-max(1, -(-N // runs)) // threads) * threads
    rows = max(rows, _FLAT_MIN_ROWS * threads)
    return dict(rc=rc, threads=threads, smem=smem, chunks=chunks, rows=rows,
                blocks=chunks * -(-N // rows))


def adc_lookup(lut: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor | None = None,
               ids: torch.Tensor | None = None) -> torch.Tensor:
    """Flat ADC scores (b, Dp, K) × (N, Dp) -> (b, N) float32. ``scales``
    (b, Dp, 2): int8/uint8 LUT pack. ``ids`` (N,): rows with id < 0 score
    −inf. On the card each code row is read once for up to four queries
    (``adc_lookup_plan``)."""
    if not _on_card(lut, codes, scales, ids):
        return ref.adc_lookup_ref(lut, codes, scales, ids)
    N = codes.shape[0]
    b, Dp, K, kind = _check_scan_operands(lut, scales, codes, ids, N)
    out = torch.empty((b, N), dtype=torch.float32, device=lut.device)
    if b and N:
        plan = adc_lookup_plan(b, N, Dp, K, _sms(lut.device))
        if plan["blocks"] > 2**31 - 1:
            raise ValueError(f"adc_lookup: {plan['blocks']} blocks exceed "
                             "the grid's x limit")
        with torch.cuda.device(lut.device):
            err = _build.library().repro_adc_lookup(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(ids),
                _ptr(out), b, N, Dp, K, plan["rc"], plan["rows"],
                plan["blocks"], plan["threads"], plan["smem"],
                _stream(lut.device))
        _build.check(err, "adc_lookup")
        LAUNCHES["adc_lookup"] += 1
    return out


def batch_planes(tables: int) -> tuple[int, ...]:
    """The plane widths of a chunk of the grouped scan: fours, then a two
    and a one where the chunk leaves them (6 -> (4, 2), 12 -> (4, 4, 4))."""
    return ((4,) * (tables // 4) + (2,) * (tables % 4 // 2)
            + (1,) * (tables % 2))


def adc_batch_plan(g: int, r: int, S: int, Dp: int, K: int,
                   sms: int) -> dict:
    """Launch plan of the grouped scan of g groups of r (Dp, K) tables over
    S code rows each, on a card with ``sms`` SMs.

    A block stages a chunk of ``chunk`` of a group's tables as float32
    planes (``batch_planes``: entry (d, k) of four tables in one float4)
    and scores each code row it reads against all of them. The chunk is
    the one of at most ``_BATCH_MAX_TABLES`` tables that fit in a block's
    shared memory whose ``chunks`` = ⌈r / chunk⌉ chunks need the fewest
    expected shared-memory wavefronts a code byte (``_PLANE_WAVEFRONTS``;
    the last chunk may be partial and costs as a whole one), the larger on
    a tie: all r tables in one chunk where they fit (6 at Dp = 16), three
    chunks of four where twelve do not (Dp = 24). Blocks of 1024 threads
    where one block fills an SM's shared memory, or where two do and their
    chunk is at most ``_BATCH_WIDE_TABLES`` tables, which the kernel runs
    in 32 registers a thread for float32 tables (two such blocks hold an
    SM's 64 warps; six tables take more, so two blocks of 512); else
    ``_BATCH_THREADS``. Each takes a run of ``rows`` code rows (a multiple
    of its threads, at least ``_BATCH_MIN_ROWS`` a thread), cut so that
    the grid of g × chunks × row runs is about ``_BATCH_WAVES`` resident
    waves: a block restages its tables from L2 (96 KiB at grok-1's six),
    so fewer, longer runs stage less, and whole waves leave no SM idle at
    the end (``kernel_bench.py --sweep`` times other constants). The grid
    is (``blocks``, g): the chunks of a row run sit side by side and share
    its codes in L2."""
    fit = min(_BATCH_MAX_TABLES, _SMEM_LIMIT // max(1, 4 * Dp * K))
    if fit < 1:
        raise ValueError(f"a (Dp={Dp}, K={K}) float32 table does not fit in "
                         "one block's shared memory")

    def wavefronts(c: int) -> float:
        return -(-r // c) * sum(_PLANE_WAVEFRONTS[w] for w in batch_planes(c))

    chunk = min(range(min(fit, max(r, 1)), 0, -1), key=wavefronts)
    chunks = -(-r // chunk) if r else 0
    smem = 4 * chunk * Dp * K
    fit_blocks = _SM_SMEM // (smem + _BLOCK_SMEM)
    threads = (1024 if fit_blocks == 1 or (
        fit_blocks == 2 and chunk <= _BATCH_WIDE_TABLES) else _BATCH_THREADS)
    target = _BATCH_WAVES * sms * _resident(threads, smem)
    runs = max(1, -(-target // max(1, g * chunks)))
    rows = -(-max(1, -(-S // runs)) // threads) * threads
    rows = max(rows, _BATCH_MIN_ROWS * threads)
    blocks = chunks * -(-S // rows)
    return dict(chunk=chunk, chunks=chunks, planes=batch_planes(chunk),
                threads=threads, smem=smem, rows=rows, blocks=blocks,
                grid=(blocks, g))


def adc_batch(lut: torch.Tensor, codes: torch.Tensor,
              scales: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped ADC scores (g, r, Dp, K) × (g, S, Dp) -> (g, r, S) float32,
    the KV-cache decode scorer (group = one (batch, kv-head) pair, r = the
    GQA repetition). ``scales`` (g, r, Dp, 2): int8/uint8 LUT pack. The
    uint8 codes go to the kernel as they are stored; no widened copy of the
    cache is made. On the card each code row is read once for a chunk of
    the group's tables (``adc_batch_plan``)."""
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
    plan = adc_batch_plan(g, r, S, Dp, K, _sms(lut.device))
    if g > 65535:
        raise ValueError(f"adc_batch: {g} groups exceed the grid's y limit")
    if plan["blocks"] > 2**31 - 1:
        raise ValueError(f"adc_batch: S={S} in {plan['chunks']} table chunks "
                         "exceeds the grid's x limit")
    out = torch.empty((g, r, S), dtype=torch.float32, device=lut.device)
    if g and r and S:
        with torch.cuda.device(lut.device):
            err = _build.library().repro_adc_batch(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(out), g, r,
                S, Dp, K, plan["chunk"], plan["chunks"], plan["rows"],
                plan["blocks"], plan["threads"], plan["smem"],
                _stream(lut.device))
        _build.check(err, "adc_batch")
        LAUNCHES["adc_batch"] += 1
    return out


def ivf_adc_plan(S: int, b: int, block_size: int, Dp: int, K: int,
                 sms: int) -> dict:
    """Launch plan of the IVF scan of an S-step schedule over b queries on
    a card with ``sms`` SMs; blocks of 512 threads, each holding one query's
    float32 table and a window of ``_IVF_WINDOW`` schedule steps in shared
    memory.

    A block takes a run of consecutive steps and scores 512 of its rows at
    a time (four 128-row tiles). Where S is a multiple of b the plan takes
    the schedule for query-major, S / b steps a query, as the search layer
    lays it out, and cuts each query's steps into ``runs_per_query`` runs
    that never cross a query, so a block stages one table: as many runs as
    give the grid about ``_IVF_WAVES`` resident waves (``_IVF_BLOCKS``
    blocks an SM), none shorter than ``_IVF_MIN_PASSES`` passes of the
    block. Otherwise runs of ``run`` steps in schedule order, sized alike.
    The kernel checks each window of its run and restages the table
    wherever the query changes, so every step is scored with its own
    query's table whatever the schedule: the plan moves only the cost.
    ``kernel_bench.py --sweep`` times other values of the constants at
    serve_p99 and the Engine's buckets."""
    smem = 4 * Dp * K + 8 * _IVF_WINDOW
    threads = _IVF_THREADS
    target = _IVF_WAVES * sms * min(_IVF_BLOCKS, _resident(threads, smem))
    min_run = _IVF_MIN_PASSES * max(1, threads // block_size)
    if b and S % b == 0:
        spq = S // b
        per_q = max(1, min(-(-target // b), spq // min_run))
        run = -(-spq // per_q)
        per_q = -(-spq // run)
        return dict(threads=threads, smem=smem, run=run,
                    runs_per_query=per_q, steps_per_query=spq,
                    blocks=b * per_q)
    run = max(min_run, -(-S // target))
    return dict(threads=threads, smem=smem, run=run, runs_per_query=0,
                steps_per_query=0, blocks=-(-S // run))


def ivf_adc_run_starts(plan: dict, S: int, device=None) -> torch.Tensor:
    """The first schedule step of each block of an ``ivf_adc_plan``."""
    blk = torch.arange(plan["blocks"], device=device)
    if plan["steps_per_query"]:
        per_q = plan["runs_per_query"]
        return (blk // per_q * plan["steps_per_query"]
                + blk % per_q * plan["run"])
    return blk * plan["run"]


def ivf_adc(lut: torch.Tensor, codes: torch.Tensor, block_idx: torch.Tensor,
            block_query: torch.Tensor, scales: torch.Tensor | None = None,
            ids: torch.Tensor | None = None, *,
            block_size: int = 128) -> torch.Tensor:
    """Selected-block IVF-ADC scan: (b, Dp, K) LUTs × (cap, Dp) CSR codes ×
    (S,) tile schedule -> (S, block_size) float32. ``block_idx`` may repeat
    and may point at the sentinel block. ``scales``: int8/uint8 LUT pack.
    ``ids`` (cap,): rows with id < 0 score −inf. Any schedule gives the
    same scores; the card's launch plan (``ivf_adc_plan``) is fastest for
    the search layer's query-major one."""
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
        plan = ivf_adc_plan(S, b, block_size, Dp, K, _sms(lut.device))
        if plan["smem"] > _SMEM_LIMIT:
            raise ValueError(f"ivf_adc: a (Dp={Dp}, K={K}) table and the "
                             "schedule window do not fit in one block's "
                             "shared memory")
        if plan["blocks"] > 2**31 - 1:
            raise ValueError(f"ivf_adc: {plan['blocks']} blocks exceed the "
                             "grid's x limit")
        with torch.cuda.device(lut.device):
            err = _build.library().repro_ivf_adc(
                _ptr(lut), kind, _ptr(scales), _ptr(codes), _ptr(block_idx),
                _ptr(block_query), _ptr(ids), _ptr(out), S, Dp, K,
                block_size, plan["run"], plan["runs_per_query"],
                plan["steps_per_query"], plan["blocks"], plan["threads"],
                plan["smem"], _stream(lut.device))
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


def lut_runs(n: int, run_len: int | None = None) -> int:
    """The runs of the fused_lut rotation's sums over n inputs: ceil(n /
    run_len) runs of ceil(n / runs) inputs each, added in run order. A
    function of n alone (and of ``_LUT_RUN_LEN``), so a query's table is
    summed in one order, and is bit-equal, whatever batch it is built in."""
    return max(1, -(-n // (run_len or _LUT_RUN_LEN)))


def _lut_rotation(n: int, sub: int, tile: int, group: int, run_len: int):
    """(rq, runs, smem) of a fused_lut block of ``tile`` queries and
    ``group`` columns: register tiles of rq queries × 4 slab columns, rq
    the most (up to 8) that still keeps every thread busy with the
    ``lut_runs(n)`` runs of the inputs (a thread walks several runs where
    the register tiles × runs outnumber the threads), and ``runs``;
    ``smem`` (``smem_bytes`` in the source) the (n, group·sub) slab, the
    padded (tile, n + 4) query tile and the runs' partial sums. None where
    the register tiles alone outnumber the threads."""
    gs4 = group * sub // 4
    runs = lut_runs(n, run_len)
    rq = min(8, tile)
    while rq > 1 and (tile // rq) * gs4 * runs < _LUT_THREADS:
        rq //= 2
    t1 = (tile // rq) * gs4
    if t1 > _LUT_THREADS:
        return None
    smem = 4 * (n * 4 * gs4 + tile * (n + 4) + runs * tile * 4 * gs4)
    return rq, runs, smem


def fused_lut_plan(b: int, n: int, Dp: int, K: int, sub: int,
                   sms: int) -> dict | None:
    """Launch plan of the fused_lut kernel for b queries of width n, Dp
    code columns of K codewords of width sub, on a card with ``sms`` SMs;
    every block has 256 threads.

    A block owns a ``tile`` of queries (a power of two up to 32, no wider
    than b needs), a ``group`` of code columns (a power of two, at most as
    many as give each thread four codewords of one column: 4 at K = 256)
    and a span of ``kc`` codewords (a multiple of 4; K split in ``ksplit``
    spans); ``_lut_rotation`` lays out its rotation, whose runs of the
    inputs, and so every entry's order of sums, depend on n alone
    (``lut_runs``): the tile, rq, the group and the span change the
    schedule and never the result. Of the layouts whose
    shared memory fits, the plan takes the one that reads the fewest bytes
    from L2 (each block reads its query tile, the group's qdelta slab and
    its codewords) among those whose grid has at least ``_LUT_FILL`` × sms
    blocks (128 on an H100: the grid comes in powers of two, and one block
    an SM stages, rotates and writes faster than two that read the same
    operands twice); where none has, the one with the most blocks. Ties go
    to the wider group, then the wider tile. None where no layout fits.
    ``kernel_bench.py --sweep`` times other values of the constants. The
    plan is worked out once per shape and setting of the constants (a few
    tens of µs of Python, more than the kernel takes at small b)."""
    plan = _lut_plan(b, n, Dp, K, sub, sms, _LUT_FILL, _LUT_RUN_LEN)
    return None if plan is None else dict(plan)


@functools.lru_cache(maxsize=256)
def _lut_plan(b: int, n: int, Dp: int, K: int, sub: int, sms: int,
              fill: float, run_len: int) -> dict | None:
    k4 = -(-K // 4)
    target = fill * sms
    g0 = 1 << (max(1, min(Dp, _LUT_THREADS // max(k4, 1))).bit_length() - 1)
    best, best_key = None, None
    for tile in _LUT_TILES:
        if tile > 1 and tile // 2 >= b:
            continue
        group = g0
        while group >= 1:
            rot = _lut_rotation(n, sub, tile, group, run_len)
            if rot is not None and rot[2] <= _SMEM_LIMIT:
                ks = 1
                while ks <= max(k4, 1):
                    kc = 4 * -(-k4 // ks)
                    ksplit = -(-K // kc) if K else 1
                    blocks = -(-b // tile) * -(-Dp // group) * ksplit
                    reads = 4 * blocks * (n * group * sub + tile * n
                                          + group * kc * sub)
                    key = ((0, reads, 0, -group, -tile) if blocks >= target
                           else (1, -blocks, reads, -group, -tile))
                    if best_key is None or key < best_key:
                        best_key = key
                        best = dict(tile=tile, group=group, kc=kc,
                                    ksplit=ksplit, rq=rot[0], runs=rot[1],
                                    threads=_LUT_THREADS, smem=rot[2],
                                    blocks=blocks)
                    if blocks >= target:
                        break
                    ks *= 2
            group //= 2
    return best


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
    subspace width must be 4, 8 or 16 and ``cb_flat`` 16-byte aligned;
    ``fused_lut_plan`` lays out the launch."""
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
    out = torch.empty((b, Dp, K), dtype=torch.float32, device=Q.device)
    if b and Dp and K:
        plan = fused_lut_plan(b, n, Dp, K, sub, _sms(Q.device))
        if plan is None:
            raise ValueError(f"fused_lut: at n={n} and sub={sub} not even one "
                             "query and one column fit in one block's shared "
                             "memory")
        if plan["blocks"] > 2**31 - 1:
            raise ValueError(f"fused_lut: {plan['blocks']} blocks exceed the "
                             "grid's x limit")
        with torch.cuda.device(Q.device):
            err = _build.library().repro_fused_lut(
                _ptr(Q), _ptr(qdelta), _ptr(cb_flat), _ptr(cols), _ptr(out),
                b, n, Dp, K, sub, plan["tile"], plan["group"], plan["kc"],
                plan["rq"], plan["runs"], plan["smem"], _stream(Q.device))
        _build.check(err, "fused_lut")
        LAUNCHES["fused_lut"] += 1
    return out


def topk_merge(scores: torch.Tensor, ids: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, C) candidates -> (b, k) top-k under the −inf/−1 padding contract,
    equal scores ranked by ascending id. Plain torch on every device."""
    return ref.topk_merge_ref(scores, ids, k)
