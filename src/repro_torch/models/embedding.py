"""Embedding-table substrate (port of ``repro/models/embedding.py``).

``bag_lookup`` sums each bag through ``kernels.ops.embedding_bag``: the
embedding_bag kernel on the card, its plain version on the CPU, with a
plain dense ``index_add_`` backward. The JAX package's two-tower model
calls its ``bag_lookup`` with ``use_kernel=False`` (its Pallas kernel has no
VJP) and takes a masked ``jnp.take`` plus a sum; the function is the same,
so the port puts its kernel there.

``sharded_lookup`` is the JAX package's row-sharded lookup (a
``shard_map`` with one psum), one process driving the shards: each shard
masks the ids it owns, gathers from its own rows, writes zeros where it
does not own the id, and the shards' outputs are summed in shard order on
the mesh's first device. Each id's row comes from one shard and the
others add exact zeros, so the result is the plain gather's bit for bit,
and autograd carries each piece its rows' gradient (a gather's
``index_put_`` backward on the piece, plus zeros), across devices when
the pieces live on several.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.sharding import placed as pl
from repro_torch.sharding import rules as sh


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


def _axis_devices(mesh, axis: str) -> list:
    """The devices of the shards along ``axis`` at coordinate 0 of every
    other axis (the first "data" row's, for a (data, model) mesh), in
    order along ``axis``."""
    names = list(mesh.shape)
    stride = 1
    for a in reversed(names[names.index(axis) + 1:]):
        stride *= mesh.shape[a]
    return [mesh.devices[k * stride] for k in range(mesh.shape[axis])]


def table_sharding(mesh, axis: str = "model", ndim: int = 2
                   ) -> sh.NamedSharding:
    """Rows over ``axis``, the rest whole: the lookup's ``P(axis, None)``."""
    return sh.NamedSharding(mesh, sh.P(axis, *(None,) * (ndim - 1)))


def sharded_lookup(table, ids: torch.Tensor, mesh, axis: str = "model"
                   ) -> torch.Tensor:
    """Row-sharded lookup: ``table`` (V, dim) as its pieces over ``axis``
    (a ``Placed`` leaf of ``table_sharding(mesh, axis)``; a whole tensor
    is placed first, as ``shard_map`` splits it). Shard s owns rows
    [s·V/S, (s+1)·V/S). Returns ``table[ids]`` on ``mesh.devices[0]``.

    The ids go to each distinct device once. With other mesh axes (a
    "data" axis above 1) the table is replicated over them, and the lookup
    runs once, over the first row's devices. V % S != 0 raises, as
    ``shard_map`` refuses an uneven split."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} has no {axis!r} axis")
    S = mesh.shape[axis]
    if isinstance(table, torch.Tensor):
        if table.shape[0] % S:
            raise ValueError(f"{table.shape[0]} rows do not split {S} ways "
                             f"over {axis!r}")
        table = pl.place(table, table_sharding(mesh, axis, table.dim()))
    pieces = table.pieces
    if len(pieces) != S:
        raise ValueError(f"{len(pieces)} table pieces for {S} shards of "
                         f"{axis!r}")
    rows_per = pieces[0].shape[0]
    if any(p.shape != pieces[0].shape for p in pieces):
        raise ValueError("table pieces of unequal shapes: "
                         f"{[tuple(p.shape) for p in pieces]}")
    head = mesh.devices[0]
    devs = _axis_devices(mesh, axis)
    ids = ids.long()
    on: dict = {}
    out = None
    for s, piece in enumerate(pieces):
        dev = piece.device
        if str(dev) not in on:
            on[str(dev)] = ids if ids.device == dev else ids.to(dev)
        if dev != devs[s]:
            raise ValueError(f"piece {s} is on {dev}, the mesh puts shard "
                             f"{s} of {axis!r} on {devs[s]}")
        ids_s = on[str(dev)]
        local = ids_s - s * rows_per
        ok = (local >= 0) & (local < rows_per) & (ids_s >= 0)
        # an id the shard does not own reads (and, backward, adds zeros to)
        # a row spread by id, not one clamped row: the backward's
        # index_put_ sums each row's run in order, and a clamp would make
        # two runs of most of the ids
        rows = piece[torch.where(ok, local, ids_s.remainder(rows_per))]
        part = torch.where(ok[..., None], rows, rows.new_zeros(()))
        part = part if dev == head else part.to(head)
        out = part if out is None else out + part
    return out
