"""Work of one IVF-PQ search batch: b queries of width n, L lists, D
subspaces of K codewords, ``nprobe`` lists probed per query.

``probed_rows`` (b,) are the rows in the lists each query probes, and
``union_rows`` the rows in the union of the batch's probed lists: the work
depends on the data, so it is counted from what these inputs need.

Operations: the rotation Q·R (2bn²), the coarse scores QR·Cᵀ (2bnL), the
lookup tables (2bnK: each subspace's sub-vector against its K codewords),
and per probed row D table adds and the coarse term's add.

Bytes, the least any implementation must move: the queries, R, the
centroids and codebooks read once; the code (D bytes) and id (4 bytes) of
each row in the union read once (queries can share them); the top-k
scores and ids written. The scan kernel alone (``scan_bytes``) reads its
tables, the union's codes and ids, and writes one float32 score per
probed row.
"""
from __future__ import annotations


def batch_flops(b: int, n: int, L: int, D: int, K: int,
                probed_rows: int) -> float:
    """Operations of one batch; ``probed_rows`` summed over its queries."""
    return 2.0 * b * n * n + 2.0 * b * n * L + 2.0 * b * n * K \
        + float(probed_rows) * (D + 1)


def batch_bytes(b: int, n: int, L: int, D: int, K: int, k: int,
                union_rows: int) -> float:
    """The least bytes one batch moves."""
    reads = 4.0 * (b * n + n * n + L * n + n * K)
    return reads + float(union_rows) * (D + 4) + 8.0 * b * k


def scan_bytes(b: int, D: int, K: int, union_rows: int,
               probed_rows: int) -> float:
    """The least bytes the scan kernel moves for one batch."""
    return 4.0 * b * D * K + float(union_rows) * (D + 4) \
        + 4.0 * float(probed_rows)
