"""Core primitives (port of ``repro/core``): Givens rotations, pair
matching, the trainable index layer and the PQ-compressed KV cache."""
