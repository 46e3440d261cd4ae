"""Work of one joint training step of the two-tower model with the index
layer (batch B, history length H, embedding e, tower widths, index width n
with D subspaces of K codewords, P trainable elements besides R).

Operations, forward: the history bag's adds (B·H·e), each tower layer
(2·B·d_in·d_out, two towers), the index layer's two rotations (2·B·n²
each), one nearest-codeword search (2·B·n·K), the (B, B) scores
(2·B²·n) and the hinge's four elementwise passes (4·B²). Backward: twice
each product (both operands' gradients), the hinge's two passes, the
bag's adds again. The optimizer: 12 operations an element for Adam, and
for GCD the score field GᵀR (2·n³). Elementwise work on (B, n) tensors is
left out: it is under 0.1% of the step.

Bytes, the least any implementation must move: Adam reads and writes
every parameter and both moments once (24 bytes an element). A dense
gradient, the (B, B) matrices and the activations need not reach memory
in a fused implementation, so they are not counted.
"""
from __future__ import annotations


def step_flops(B: int, H: int, e: int, towers: tuple, n: int, K: int,
               P: int) -> float:
    dims = (e, *towers)
    mlp = sum(2.0 * B * a * b for a, b in zip(dims, dims[1:]))
    fwd = (B * H * e + 2 * mlp + 2 * (2.0 * B * n * n) + 2.0 * B * n * K
           + 2.0 * B * B * n + 4.0 * B * B)
    bwd = (2 * (2 * mlp + 2 * (2.0 * B * n * n) + 2.0 * B * B * n)
           + 2.0 * B * B + B * H * e)
    return fwd + bwd + 12.0 * P + 2.0 * n ** 3


def step_bytes(P: int) -> float:
    return 24.0 * P


def trainable_elements(vocab: int, e: int, towers: tuple, K: int,
                       n: int) -> int:
    """Elements Adam updates: the item table, both towers' weights and
    biases, the codebooks (R goes to the rotation learner)."""
    dims = (e, *towers)
    mlp = sum(a * b + b for a, b in zip(dims, dims[1:]))
    return vocab * e + 2 * mlp + K * n
