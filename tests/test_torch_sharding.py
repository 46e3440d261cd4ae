"""The port's sharding rules and the production meshes' specs, held to the
JAX package: every table of ``RULE_REGISTRY``, ``logical_to_spec``'s
resolution and warnings, and for all 40 grid cells on both production
meshes the ``in_shardings`` / ``out_shardings`` specs leaf for leaf, the
abstract arguments and the warnings, against the JAX package's
``repro.launch.cells.build_cell`` on an ``AbstractMesh`` in this process
(``repro.launch.dryrun`` is never imported: it sets ``XLA_FLAGS``).

A module-scoped subprocess with 8 forced host devices holds
``NamedSharding.devices_indices_map`` and ``shard`` against JAX's for a
few specs, and the dry run's reckoned ``argument_bytes`` of one small
cell against the JAX dry run's compiled ``report["memory"]
["argument_bytes"]`` on a (2, 4) and a (2, 2, 2) mesh (the pattern of
``tests/test_distributed.py::test_mini_dryrun_cell_compiles_on_8_devices``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.sharding import rules as jsh
from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import rules as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = configs.grid_cells()


def _jax_flat(tree) -> dict:
    """{"a/b/c": leaf} of a JAX tree (dict keys, indices, field names)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = []
        for k in path:
            for attr in ("key", "idx", "name"):
                if hasattr(k, attr):
                    keys.append(str(getattr(k, attr)))
                    break
        out["/".join(keys)] = leaf
    return out


def _port_flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, (sh.NamedSharding, cells.Abstract)):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# -- the rule tables -----------------------------------------------------------


def test_rule_registry_has_the_jax_keys():
    assert list(sh.RULE_REGISTRY) == list(jsh.RULE_REGISTRY)
    assert len(sh.RULE_REGISTRY) == 13


@pytest.mark.parametrize("key", list(jsh.RULE_REGISTRY))
def test_rule_table_equals_jax(key):
    assert sh.RULE_REGISTRY[key] == jsh.RULE_REGISTRY[key]


@pytest.mark.parametrize("name", ["LM_BASE_RULES", "GNN_BASE_RULES",
                                  "RECSYS_BASE_RULES", "PAPER_RULES",
                                  "IVF_RULES", "IVF_SHARDED_RULES"])
def test_base_tables_equal_jax(name):
    assert getattr(sh, name) == getattr(jsh, name)


def test_merge_and_merge_rules():
    base = {"a": None, "b": "model"}
    for mod in (sh, jsh):
        assert mod.merge(base, b="data") == {"a": None, "b": "data"}
        assert mod.merge_rules(base, c="x") == {"a": None, "b": "model",
                                                "c": "x"}
    assert base == {"a": None, "b": "model"}


@pytest.mark.parametrize("arch_id", sorted({a for a, _ in CELLS}))
def test_configs_carry_the_jax_rule_table(arch_id):
    spec, jspec = configs.get(arch_id), jconfigs.get(arch_id)
    for shape in spec.shapes:
        cfg, jcfg = spec.config_for_shape(shape), jspec.config_for_shape(
            shape)
        assert cfg.rules == jcfg.rules
        assert cfg.rule_table == jcfg.rule_table


# -- logical_to_spec -----------------------------------------------------------

SPEC_CASES = {
    "pod_filtered": (("act_batch", "act_seq"), "lm_base", (32, 8), "16x16"),
    "pod_kept": (("act_batch", "act_seq"), "lm_base", (64, 8), "2x16x16"),
    "not_dividing": (("act_heads", None), "lm_base", (20, 4), "16x16"),
    "tuple_not_dividing": (("act_batch",), "gnn", (48,), "2x16x16"),
    "duplicate_axis": (("w_experts", "w_expert_mlp"), "lm_base", (16, 32),
                       "16x16"),
    "duplicate_after_drop": (("w_experts", "w_expert_mlp"), "lm_base",
                             (8, 32), "16x16"),
    "two_axes_one_dim": (("act_kv_seq",), "lm_long_ctx", (512,), "16x16"),
    "absent_name": (("no_such_axis", None), "recsys", (4, 4), "16x16"),
    "no_shape": (("vocab_rows", "w_embed_dim"), "recsys", None, "2x16x16"),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_logical_to_spec_equals_jax(case):
    logical, table, shape, mesh_name = SPEC_CASES[case]
    sizes, axes = MESHES[mesh_name]
    jsh.pop_warnings()
    sh.pop_warnings()
    want = jsh.logical_to_spec(logical, jsh.RULE_REGISTRY[table],
                               AbstractMesh(sizes, axes), shape, "t")
    got = sh.logical_to_spec(logical, sh.RULE_REGISTRY[table],
                             mesh_lib.abstract_mesh(sizes, axes), shape, "t")
    assert tuple(got) == tuple(want)
    assert sh.pop_warnings() == jsh.pop_warnings()


def test_tree_specs_and_shardings():
    mesh = mesh_lib.abstract_mesh(*MESHES["16x16"])
    logical = {"t": ("vocab_rows", "w_embed_dim"), "b": {"w": ("w_hidden",)},
               "s": ()}
    shapes = {"t": (64, 8), "b": {"w": (24,)}, "s": ()}
    sh.pop_warnings()
    specs = sh.tree_specs(logical, sh.RECSYS_BASE_RULES, mesh, shapes)
    assert specs == {"t": ("model", None), "b": {"w": (None,)}, "s": ()}
    assert len(sh.pop_warnings()) == 1           # 24 % 16
    shard = sh.tree_shardings(logical, sh.RECSYS_BASE_RULES, mesh)
    assert tuple(shard["b"]["w"].spec) == ("model",)
    assert shard["t"].mesh is mesh


def test_constrain_resolves_and_returns_x():
    mesh = mesh_lib.abstract_mesh(*MESHES["16x16"])
    x = torch.ones(8, 3)
    sh.pop_warnings()
    assert sh.constrain(x, ("act_batch", None), sh.RECSYS_BASE_RULES,
                        mesh) is x
    assert sh.pop_warnings() == [
        "?: logical axis 'act_batch' dim 8 not divisible by mesh axes "
        "('data',) (size 16) — replicated"]
    assert sh.constrain(x, ("act_batch", None), sh.RECSYS_BASE_RULES) is x
    assert sh.pop_warnings() == []


# -- the production meshes -----------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    name = "2x16x16" if multi_pod else "16x16"
    sizes, axes = MESHES[name]
    am = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
    assert am.shape == dict(zip(axes, sizes)) and am.name == name
    n = int(np.prod(sizes))
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                      devices=("cpu",) * n)
    assert m.shape == am.shape and len(m.devices) == n
    with pytest.raises(ValueError, match="item 11b"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_specs_and_warnings_equal_jax(arch_id, shape, mesh_name):
    sizes, axes = MESHES[mesh_name]
    jsh.pop_warnings()
    jc = jcells.build_cell(arch_id, shape, AbstractMesh(sizes, axes))
    jwarn = sorted(set(jsh.pop_warnings()))
    sh.pop_warnings()
    tc = cells.build_cell(arch_id, shape,
                          mesh=mesh_lib.abstract_mesh(sizes, axes))
    twarn = sorted(set(sh.pop_warnings()))
    assert twarn == jwarn
    for what in ("in_shardings", "out_shardings"):
        want = {k: tuple(v.spec)
                for k, v in _jax_flat(getattr(jc, what)).items()}
        got = {k: tuple(v.spec)
               for k, v in _port_flat(getattr(tc, what)).items()}
        assert got == want, what
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _jax_flat(jc.abstract_inputs).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _port_flat(tc.abstract_inputs).items()}
    assert got == want


def test_dryrun_records_carry_the_production_meshes():
    rec = dryrun.run_cell("graphsage-reddit", "molecule", device="cpu",
                          verbose=False)
    assert rec["ok"], rec.get("error")
    pm = rec["production_mesh"]
    assert pm == dryrun.production_mesh("graphsage-reddit", "molecule")
    wide = dryrun.production_mesh("wide-deep", "train_batch")
    for name, entry in pm.items():
        sizes, axes = MESHES[name]
        assert entry["from"] == "reckoned"
        assert entry["n_chips"] == int(np.prod(sizes))
        assert entry["argument_bytes"] > 0
        jsh.pop_warnings()
        jcells.build_cell("wide-deep", "train_batch",
                          AbstractMesh(sizes, axes))
        assert wide[name]["sharding_warnings"] == sorted(
            set(jsh.pop_warnings())) != []


def test_recsys_tables_split_sixteen_ways_on_the_production_mesh():
    mesh = mesh_lib.abstract_production_mesh()
    cell = cells.build_cell("wide-deep", "train_batch", mesh=mesh)
    table = cell.in_shardings[0].params["table"]
    assert tuple(table.spec) == ("model", None)
    assert table.shard_shape((40_000_000, 32)) == (2_500_000, 32)


def test_dryrun_production_cli(capsys):
    assert dryrun.main(["--arch", "din", "--shape", "serve_p99",
                        "--production"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["production_mesh"] == dryrun.production_mesh("din",
                                                             "serve_p99")


# -- NamedSharding on devices, against JAX (8 forced host devices) --------------

SHARDING_CASES = [((16, 8), ("model", None)), ((16, 8), (None, "model")),
                  ((16,), (("data", "model"),)), ((16,), ("data",)),
                  ((4, 4), ()), ((16, 8), (("model", "data"), None)),
                  ((8, 12), ("data", "model"))]
ARG_CELL = ("graphsage-reddit", "molecule")

CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.launch.mesh as mesh_lib
    from repro.launch.mesh import make_mesh_compat

    cases = json.loads(sys.argv[1])
    arch, shape = json.loads(sys.argv[2])
    mesh = make_mesh_compat((2, 4), ("data", "model"))
    out = {"maps": [], "shards": []}

    def spec(entries):
        return P(*[tuple(e) if isinstance(e, list) else e for e in entries])

    for shp, entries in cases:
        ns = NamedSharding(mesh, spec(entries))
        m = ns.devices_indices_map(tuple(shp))
        out["maps"].append([[[s.start, s.stop] for s in m[d]]
                            for d in mesh.devices.flat])
        x = jnp.arange(int(np.prod(shp)), dtype=jnp.float32).reshape(shp)
        arr = jax.device_put(x, ns)
        by_dev = {s.device: np.asarray(s.data).tolist()
                  for s in arr.addressable_shards}
        out["shards"].append([by_dev[d] for d in mesh.devices.flat])

    mesh_lib.make_production_mesh = lambda multi_pod=False: make_mesh_compat(
        (2, 2, 2) if multi_pod else (2, 4),
        ("pod", "data", "model") if multi_pod else ("data", "model"))
    from repro.launch.dryrun import run_cell
    out["argument_bytes"] = {}
    for mp in (False, True):
        rec = run_cell(arch, shape, mp, verbose=False)
        assert rec["ok"], rec.get("error")
        out["argument_bytes"]["2x2x2" if mp else "2x4"] = \\
            rec["report"]["memory"]["argument_bytes"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_devices():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(SHARDING_CASES),
             json.dumps(ARG_CELL)],
            capture_output=True, text=True, env=env, timeout=420, cwd=d)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.splitlines()[-1])


def _slices(idx) -> list:
    return [[s.start, s.stop] for s in idx]


@pytest.mark.parametrize("case", range(len(SHARDING_CASES)))
def test_devices_indices_map_and_shard_equal_jax(jax_devices, case):
    shape, entries = SHARDING_CASES[case]
    mesh = mesh_lib.make_mesh_compat((2, 4), ("data", "model"),
                                     devices=("cpu",) * 8)
    ns = sh.NamedSharding(mesh, sh.P(*entries))
    m = ns.devices_indices_map(shape)
    assert [_slices(m[s]) for s in range(8)] == jax_devices["maps"][case]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    pieces = ns.shard(x)
    assert [p.tolist() for p in pieces] == jax_devices["shards"][case]
    # pieces of one slice on one device are one tensor
    distinct = list({id(p): p for p in pieces}.values())
    assert len(distinct) == len(ns.distinct(shape))
    assert torch.equal(ns.gather(pieces), x)
    assert torch.equal(ns.gather(distinct, shape), x)


@pytest.mark.parametrize("mesh_name,sizes,axes",
                         [("2x4", (2, 4), ("data", "model")),
                          ("2x2x2", (2, 2, 2), ("pod", "data", "model"))])
def test_argument_bytes_equal_the_jax_dry_run(jax_devices, mesh_name, sizes,
                                              axes):
    cell = cells.build_cell(*ARG_CELL,
                            mesh=mesh_lib.abstract_mesh(sizes, axes))
    assert cells.argument_bytes(cell) == \
        jax_devices["argument_bytes"][mesh_name]
