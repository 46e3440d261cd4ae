"""Logical-axis sharding rules (port of ``repro/sharding/rules.py``).

Every parameter and major activation of the model zoo is annotated with a
tuple of *logical* axis names. A per-architecture rule table maps logical
names to mesh axes; ``logical_to_spec`` resolves the tuple into a
``PartitionSpec`` against a mesh's axis sizes. The tables and the
resolution are the JAX package's, warning texts included:

  * rule value None  → axis replicated
  * rule value str   → single mesh axis
  * rule value tuple → multiple mesh axes (e.g. batch over ("pod", "data"))
  * a logical axis absent from the table → replicated
  * a mesh axis the mesh lacks ("pod" on the single-pod mesh) is dropped
  * a mesh axis that does not divide the dimension is dropped, and the
    JAX package's warning text is recorded for the dry-run report
  * a mesh axis named twice is kept at its first use only

Resolution reads only the mesh's ``shape`` (axis name → size), so it runs
on ``launch.mesh.AbstractMesh`` with nothing allocated, as the JAX
package's does on an ``AbstractMesh``.

``NamedSharding(mesh, spec)`` is the port's record of a resolved leaf.
One process drives every shard (the JAX package's single controller):
shard ``s`` of a mesh lives on ``mesh.devices[s]``, in row-major order of
the axes. ``devices_indices_map(shape)`` gives each shard's slice (keyed
by shard position, since several shards may share one device),
``shard(x)`` the pieces in mesh order, and ``gather(pieces)`` the whole
tensor on the mesh's first device. Pieces that hold the same slice on one
device are one tensor, not copies.

``constrain`` is ``with_sharding_constraint`` by logical names: it
resolves the spec (so it records the same warnings) and returns ``x``
unchanged. A sharding constraint never changes a value, and a layout pin
has no counterpart when one process holds the tensor whole. The port has
no ambient mesh: without a ``mesh`` it does nothing, as the JAX function
does outside a mesh context.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch

# ---------------------------------------------------------------------------
# Base rule tables
# ---------------------------------------------------------------------------

# Dense/GQA transformer LM. Weights ZeRO-shard their biggest dim over "data"
# and tensor-shard over "model"; activations shard batch over (pod, data) and
# the model-parallel dim over "model".
LM_BASE_RULES: dict[str, Any] = {
    # --- activations ---
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_seq": None,          # decode cache seq; decode cells flip to "model"
    "act_boundary_seq": None,    # saved layer boundaries; big-train rules
    #                              shard these over "model" (ZeRO-activations)
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",      # MoE dispatch buffer expert dim (EP)
    "act_capacity": "data",      # MoE dispatch buffer capacity dim
    "act_expert_mlp": "model",   # expert hidden dim (takes over when E < 16)
    "act_tokens": "data",        # flattened token dim in MoE dispatch
    # --- weights ---
    # ZeRO/FSDP axis; "pod" is filtered out on the single-pod mesh, so
    # multi-pod runs ZeRO-shard across pods too.
    "w_embed": ("pod", "data"),
    "w_heads": "model",
    "w_kv_heads": None,          # GQA: kv heads usually < 16 → replicate
    "w_head_dim": None,
    "w_mlp": "model",
    "w_vocab": "model",
    "w_experts": "model",        # expert parallelism (EP)
    # When E doesn't divide the model axis (grok: 8 experts < 16), the
    # divisibility check drops the EP sharding and this rule tensor-shards
    # the expert hidden dim instead (dedup keeps whichever lands first).
    "w_expert_mlp": "model",
    "layers": None,              # scan axis: never sharded
}

GNN_BASE_RULES: dict[str, Any] = {
    "act_nodes": ("pod", "data"),
    "act_edges": ("pod", "data"),
    "act_feat": None,
    "act_hidden": None,
    "w_in": None,
    "w_out": "model",
    "layers": None,
}

RECSYS_BASE_RULES: dict[str, Any] = {
    "act_batch": ("pod", "data"),
    "act_feat": None,
    "act_hidden": "model",
    "act_cand": ("pod", "data"),   # candidate axis for bulk/retrieval scoring
    "vocab_rows": "model",         # embedding tables row-sharded
    "w_embed_dim": None,
    "w_in": None,
    "w_hidden": "model",
    "w_out": None,
    "fields": None,
    "layers": None,
}

# The paper's own two-tower (dim 512): tiny — replicate weights, shard batch.
PAPER_RULES: dict[str, Any] = dict(RECSYS_BASE_RULES)

# IVF-PQ serving: queries are data-parallel; the flattened candidate axis
# (nprobe·blocks·block_size per query) shards over "model". Index storage
# is replicated by default; the row-sharded variant below flips the corpus
# rows to ("pod", "data").
IVF_RULES: dict[str, Any] = {
    "act_batch": ("pod", "data"),
    "ivf_cand": "model",
    "ivf_cap": None,
    "ivf_lists": None,
    "ivf_rows": None,          # shard axis of a stacked per-shard index
}

# Row-sharded IVF (``search.sharded``): the corpus rows over the full
# product of the ("pod", "data") axes a mesh has, so a (2, 4) pod × data
# mesh gives 8 shards, not 4 shards replicated twice
# (``search.sharded.resolve_axes`` reads ``ivf_rows``). Centroids,
# codebooks and R stay replicated.
IVF_SHARDED_RULES: dict[str, Any] = dict(IVF_RULES)
IVF_SHARDED_RULES.update({
    "ivf_cap": ("pod", "data"),
    "ivf_rows": ("pod", "data"),
})

# Rotation/PQ parameters are small and replicated everywhere.
for _t in (LM_BASE_RULES, GNN_BASE_RULES, RECSYS_BASE_RULES, PAPER_RULES):
    _t.update({"rot_in": None, "rot_out": None, "pq_sub": None,
               "pq_code": None, "pq_dim": None})


def merge(base, **overrides):
    out = dict(base)
    out.update(overrides)
    return out


# Named rule tables: a config names its table by key (``cfg.rules``).
RULE_REGISTRY: dict[str, dict[str, Any]] = {
    # Head-sharded tensor parallelism (heads % 16 == 0: nemotron, grok).
    "lm_base": LM_BASE_RULES,
    # Attention data-parallel, FFN/vocab/experts tensor-parallel, for archs
    # whose head count does not divide the model axis.
    "lm_attn_dp": merge(LM_BASE_RULES, **{
        "w_heads": "data", "act_heads": None, "w_kv_heads": "data",
    }),
    # ≥300B training: the saved per-layer boundary's seq dim over "model".
    "lm_base_bigtrain": merge(LM_BASE_RULES, **{
        "act_boundary_seq": "model",
    }),
    "lm_attn_dp_bigtrain": merge(LM_BASE_RULES, **{
        "w_heads": "data", "act_heads": None, "w_kv_heads": "data",
        "act_boundary_seq": "model",
    }),
    # Decode/prefill serving: the KV cache's seq dim over "model" (context
    # parallelism); weight storage keeps tensor sharding.
    "lm_decode": merge(LM_BASE_RULES, **{
        "act_kv_seq": "model", "act_heads": None,
        "w_heads": "model", "w_kv_heads": "model",
    }),
    "lm_decode_attn_dp": merge(LM_BASE_RULES, **{
        "act_kv_seq": "model", "act_heads": None,
        "w_heads": "model", "w_kv_heads": "model",
    }),
    # Long-context decode (batch 1): the KV seq dim over data and model.
    "lm_long_ctx": merge(LM_BASE_RULES, **{
        "act_batch": None, "act_kv_seq": ("data", "model"),
        "act_heads": None, "w_heads": "model", "w_kv_heads": "model",
    }),
    "lm_long_ctx_attn_dp": merge(LM_BASE_RULES, **{
        "act_batch": None, "act_kv_seq": ("data", "model"),
        "act_heads": None, "w_heads": "model", "w_kv_heads": "model",
    }),
    "gnn": GNN_BASE_RULES,
    "recsys": RECSYS_BASE_RULES,
    "paper": PAPER_RULES,
    "ivf": IVF_RULES,
    "ivf_sharded": IVF_SHARDED_RULES,
}


def merge_rules(base: Mapping[str, Any], **overrides: Any) -> dict[str, Any]:
    out = dict(base)
    out.update(overrides)
    return out


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """A resolved spec: one entry a dimension, each None (replicated), a
    mesh axis name or a tuple of them (``jax.sharding.PartitionSpec``'s
    entries; ``tuple(spec)`` compares with the JAX spec's)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_WARNINGS: list[str] = []


def pop_warnings() -> list[str]:
    out = list(_WARNINGS)
    _WARNINGS.clear()
    return out


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= _mesh_axis_size(mesh, a)
        return size
    return mesh.shape[axis] if axis in mesh.shape else 1


def _present(mesh, axis):
    """Filter out mesh axes that don't exist on this mesh (e.g. 'pod' on the
    single-pod mesh)."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.shape)
        return kept if kept else None
    return axis if axis in mesh.shape else None


def logical_to_spec(logical_axes: Sequence[str | None],
                    rules: Mapping[str, Any], mesh,
                    shape: Sequence[int] | None = None,
                    tensor_name: str = "?") -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec, dropping (with a
    recorded warning) any mesh axis that does not divide the dimension."""
    spec = []
    for d, name in enumerate(logical_axes):
        axis = _present(mesh, rules.get(name)) if name is not None else None
        if axis is not None and shape is not None:
            size = _mesh_axis_size(mesh, axis)
            if shape[d] % size != 0:
                _WARNINGS.append(
                    f"{tensor_name}: logical axis {name!r} dim {shape[d]} not"
                    f" divisible by mesh axes {axis} (size {size}) — replicated"
                )
                axis = None
        spec.append(axis)
    # a mesh axis names one dimension at most: keep its first occurrence
    seen: set[str] = set()
    clean = []
    for axis in spec:
        if axis is None:
            clean.append(None)
            continue
        ax_tuple = axis if isinstance(axis, tuple) else (axis,)
        kept = tuple(a for a in ax_tuple if a not in seen)
        seen.update(kept)
        clean.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*clean)


def is_logical(x) -> bool:
    """A leaf of a logical tree: a plain tuple of axis names or None."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None))) for e in x))


def tree_map(fn, tree, *rest, is_leaf=is_logical):
    """``fn`` over the leaves of nested dicts, NamedTuples, lists and
    tuples (``rest`` trees of the same structure alongside), keeping the
    structure; ``is_leaf`` stops the descent."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_specs(logical_tree, rules, mesh, shape_tree=None):
    """A tree of logical-axis tuples (and optionally the matching tree of
    shapes) as the same tree of PartitionSpecs."""
    if shape_tree is None:
        return tree_map(lambda lg: logical_to_spec(lg, rules, mesh),
                        logical_tree)
    return tree_map(lambda lg, shp: logical_to_spec(lg, rules, mesh, shp),
                    logical_tree, shape_tree)


def tree_shardings(logical_tree, rules, mesh, shape_tree=None):
    specs = tree_specs(logical_tree, rules, mesh, shape_tree)
    return tree_map(lambda s: NamedSharding(mesh, s), specs,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def constrain(x, logical_axes, rules, mesh=None):
    """``with_sharding_constraint`` by logical names: resolves the spec
    against ``mesh`` (recording the same warnings as the JAX package) and
    returns ``x`` unchanged. A constraint never changes a value, and a
    layout pin has no counterpart when one process holds ``x`` whole. No
    mesh (the port has no ambient one): nothing to resolve."""
    if mesh is None:
        return x
    logical_to_spec(logical_axes, rules, mesh, tuple(x.shape))
    return x


# ---------------------------------------------------------------------------
# NamedSharding
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec on a mesh: which slice of a leaf each shard holds (module
    docstring). ``mesh`` needs ``shape`` (axis → size) for the slices, and
    ``devices`` for ``shard`` and ``gather``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={dict(self.mesh.shape)}, spec={self.spec!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding)
                and dict(self.mesh.shape) == dict(other.mesh.shape)
                and getattr(self.mesh, "devices", None)
                == getattr(other.mesh, "devices", None)
                and tuple(self.spec) == tuple(other.spec))

    __hash__ = None

    @property
    def num_shards(self) -> int:
        return math.prod(self.mesh.shape.values())

    def splits(self, ndim: int) -> tuple[int, ...]:
        """How many ways each of ``ndim`` dimensions is split."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.shape[a] for a in _axes(e))
                     for e in spec[:ndim])

    @property
    def splits_nothing(self) -> bool:
        return all(n == 1 for n in self.splits(len(self.spec)))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One shard's shape (each split dimension divided evenly)."""
        out = []
        for d, n in zip(shape, self.splits(len(shape))):
            if d % n:
                raise ValueError(f"dimension {d} does not split {n} ways "
                                 f"under {self.spec!r}")
            out.append(d // n)
        return tuple(out)

    def _coords(self, s: int) -> dict:
        """Shard ``s``'s coordinate on each mesh axis (row-major)."""
        out = {}
        for name in reversed(list(self.mesh.shape)):
            size = self.mesh.shape[name]
            out[name] = s % size
            s //= size
        return out

    def devices_indices_map(self, shape) -> dict[int, tuple]:
        """{shard position: the tuple of slices it holds}, as
        ``jax.sharding.NamedSharding.devices_indices_map`` gives per
        device (``slice(None)`` for a whole dimension); keyed by shard
        position because several shards may share one device."""
        shape = tuple(shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        local = self.shard_shape(shape)
        out = {}
        for s in range(self.num_shards):
            c = self._coords(s)
            idx = []
            for d, e in enumerate(spec[:len(shape)]):
                axes = _axes(e)
                if not axes or math.prod(self.mesh.shape[a]
                                         for a in axes) == 1:
                    idx.append(slice(None))
                    continue
                k = 0
                for a in axes:               # the first axis is the major
                    k = k * self.mesh.shape[a] + c[a]
                idx.append(slice(k * local[d], (k + 1) * local[d]))
            out[s] = tuple(idx)
        return out

    def distinct(self, shape) -> list[tuple[tuple, Any]]:
        """(slices, device) of each distinct slice, in order of first
        appearance in the mesh, on the first device that holds it."""
        seen, out = set(), []
        devices = self.mesh.devices
        for s, idx in self.devices_indices_map(shape).items():
            key = _index_key(idx)
            if key not in seen:
                seen.add(key)
                out.append((idx, devices[s]))
        return out

    def shard(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The pieces of ``x`` in mesh order, piece ``s`` on
        ``mesh.devices[s]``; shards that hold the same slice on one device
        share one tensor."""
        made: dict = {}
        out = []
        devices = self.mesh.devices
        for s, idx in self.devices_indices_map(x.shape).items():
            key = (_index_key(idx), str(devices[s]))
            if key not in made:
                made[key] = x[idx].to(devices[s]).contiguous()
            out.append(made[key])
        return out

    def gather(self, pieces: Sequence[torch.Tensor], shape=None,
               device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first device by
        default) from its pieces: one a shard in mesh order, or one a
        distinct slice (``distinct``'s order)."""
        if shape is None:
            shape = tuple(n * d for n, d in zip(
                self.splits(pieces[0].dim()), pieces[0].shape))
        idx_map = self.devices_indices_map(shape)
        if len(pieces) == len(idx_map):
            pairs = [(idx_map[s], p) for s, p in enumerate(pieces)]
        else:
            pairs = [(idx, p) for (idx, _), p in zip(self.distinct(shape),
                                                     pieces)]
        dev = self.mesh.devices[0] if device is None else torch.device(
            device)
        out = torch.empty(tuple(shape), dtype=pieces[0].dtype, device=dev)
        done = set()
        for idx, p in pairs:
            key = _index_key(idx)
            if key not in done:
                done.add(key)
                out[idx] = p.to(dev)
        return out


def _index_key(idx: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in idx)
