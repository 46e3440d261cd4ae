"""A parameter laid over a mesh as its pieces (the port's counterpart of
a ``jax.Array`` with a ``NamedSharding``).

``Placed`` is an ``nn.Module`` holding one parameter per distinct slice of
the whole leaf, named ``"0"``, ``"1"``, ... in mesh order, each on the
first device of the mesh that holds that slice. One process drives every
shard: a slice the mesh replicates (a table over a (data 2, model 4) mesh
is replicated over "data") is held once, on the first "data" row's
device, not copied to the others. The whole leaf exists only when
``gather`` builds it.

A model keeps a placed leaf under its JAX path key (``table``), and the
training code treats it as one leaf there: ``module_leaves`` yields it as
``table``, the optimizer keeps its moments as ``Placed`` of the same
sharding and updates it piece by piece, each piece's gradient on its own
device, and checkpoints store it gathered, its rows in order, the JAX
layout.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from repro_torch.sharding.rules import NamedSharding


class Placed(nn.Module):
    """A leaf of ``shape`` over ``sharding``'s mesh, as its distinct
    pieces (module docstring)."""

    def __init__(self, pieces: Sequence[torch.Tensor],
                 sharding: NamedSharding, shape, *,
                 requires_grad: bool | None = None):
        super().__init__()
        self.sharding = sharding
        self.shape = torch.Size(shape)
        want = sharding.distinct(self.shape)
        if len(pieces) != len(want):
            raise ValueError(f"{len(pieces)} pieces for {len(want)} distinct "
                             f"slices of {tuple(self.shape)} under "
                             f"{sharding.spec!r}")
        local = sharding.shard_shape(self.shape)
        self.indices = [idx for idx, _ in want]
        for i, t in enumerate(pieces):
            if tuple(t.shape) != local:
                raise ValueError(f"piece {i} has shape {tuple(t.shape)}, "
                                 f"the sharding gives {local}")
            rg = t.requires_grad if requires_grad is None else requires_grad
            self.register_parameter(str(i), nn.Parameter(t, requires_grad=rg))

    @property
    def pieces(self) -> list[torch.Tensor]:
        return [self._parameters[str(i)] for i in range(len(self.indices))]

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def requires_grad(self) -> bool:
        return any(p.requires_grad for p in self.pieces)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return self.shape.numel()

    def like(self, tensors: Sequence[torch.Tensor]) -> "Placed":
        """Other pieces of the same sharding (gradients, moments)."""
        return Placed(list(tensors), self.sharding, self.shape,
                      requires_grad=False)

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (the mesh's first device by
        default), detached."""
        with torch.no_grad():
            return self.sharding.gather([p.detach() for p in self.pieces],
                                        self.shape, device)

    @torch.no_grad()
    def copy_(self, src) -> "Placed":
        """Overwrite every piece from a whole tensor or another
        ``Placed`` of any sharding (re-sharded through its gather)."""
        if isinstance(src, Placed):
            if src.sharding == self.sharding:
                for p, q in zip(self.pieces, src.pieces):
                    p.copy_(q)
                return self
            src = src.gather()
        for p, idx in zip(self.pieces, self.indices):
            p.copy_(src[idx])
        return self


def place(x: torch.Tensor, sharding: NamedSharding, *,
          requires_grad: bool | None = None) -> Placed:
    """``x`` as a ``Placed`` leaf: its distinct slices copied to their
    devices (``x`` itself is not kept)."""
    pieces = [x.detach()[idx].to(dev).contiguous()
              for idx, dev in sharding.distinct(x.shape)]
    rg = x.requires_grad if requires_grad is None else requires_grad
    return Placed(pieces, sharding, x.shape, requires_grad=rg)


def is_placed(x) -> bool:
    return isinstance(x, Placed)


def pieces_of(x) -> list[torch.Tensor]:
    """A placed leaf's pieces, or ``[x]``."""
    return x.pieces if isinstance(x, Placed) else [x]


def map_pieces(fn: Callable, x, *rest):
    """``fn`` piece by piece over a placed leaf (and leaves of the same
    sharding alongside), as a ``Placed`` of the results; ``fn(x, *rest)``
    for plain tensors."""
    if not isinstance(x, Placed):
        return fn(x, *rest)
    return x.like([fn(*ps) for ps in zip(x.pieces,
                                         *(r.pieces for r in rest))])


def module_leaves(module: nn.Module) -> list[tuple[str, object]]:
    """(name, leaf) of every parameter of ``module`` in
    ``named_parameters`` order, a placed leaf yielded once as itself under
    its own name (``table``, not ``table.0``)."""
    placed = {n: m for n, m in module.named_modules()
              if isinstance(m, Placed)}
    out, seen = [], set()
    for n, p in module.named_parameters():
        owner = n.rsplit(".", 1)[0] if "." in n else ""
        if owner in placed:
            if owner not in seen:
                seen.add(owner)
                out.append((owner, placed[owner]))
        else:
            out.append((n, p))
    return out
