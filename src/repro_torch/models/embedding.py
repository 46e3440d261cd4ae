"""Embedding-table substrate (port of ``repro/models/embedding.py:29-58``).

``bag_lookup`` sums each bag through ``kernels.ops.embedding_bag``: the
embedding_bag kernel on the card, its plain version on the CPU, with a
plain dense ``index_add_`` backward. The JAX package's two-tower model
calls its ``bag_lookup`` with ``use_kernel=False`` (its Pallas kernel has no
VJP) and takes a masked ``jnp.take`` plus a sum; the function is the same,
so the port puts its kernel there. ``sharded_lookup`` waits for the sharded
slice (ROADMAP.md queue 1, slice 11).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain gather; its gradient is a dense (V, dim) table, as
    ``jax.grad`` of ``jnp.take`` gives."""
    return table[ids.long()]


def bag_lookup(table: torch.Tensor, ids: torch.Tensor, *,
               combiner: str = "mean") -> torch.Tensor:
    """EmbeddingBag over the last axis of ids: (..., L) -> (..., dim). Ids
    < 0 are padding; ``combiner="mean"`` divides by the number of real
    entries (at least 1)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    lead = ids.shape[:-1]
    L = ids.shape[-1]
    flat = ids.reshape(-1, L)
    B = flat.shape[0]
    bag_ids = torch.arange(B, dtype=torch.int32,
                           device=ids.device).repeat_interleave(L)
    out = kops.embedding_bag(table, flat.reshape(-1).to(torch.int32).contiguous(),
                             bag_ids, B)
    if combiner == "mean":
        cnt = torch.clamp(torch.sum(flat >= 0, dim=1), min=1)
        out = out / cnt[:, None].to(out.dtype)
    return out.reshape(*lead, table.shape[-1])
