"""Live churn under query load on the port (port of ``benchmarks/churn.py``).

A fused ``ivf`` Engine serves a steady query stream while a
``ChurnController`` interleaves, every step:

  * ``remove``: tombstone a batch of live ids (masked to −inf inside the
    scan kernels, never filtered after);
  * ``add``: stage a batch of new rows into the fixed-capacity buffer
    (served by the next query through the ``adc_lookup`` side pass);
  * a ``subspace_gcd`` delta absorbed through ``Engine.refresh`` (training
    goes on during churn);
  * the flushes and compactions the controller's thresholds call for.

The seven checks are the JAX script's (``benchmarks/churn.py:208-219``):
no new Engine executable across the run, no LUT invalidation, no grow, no
tombstoned id in any step's results (and every returned id live), every
mutation exercised, and end-state recall@10 within 0.01 of a repack of the
live rows under the same quantizers and no lower than a fresh
``ivf.build`` on them less 0.01.

The exact oracle keeps the live set as a mask over one tensor of vectors
(``pool``: the corpus, then the add stream, row = item id), not a dict of
every live vector, so it scales to the 1M-row index ``chip_smoke.py``
churns. The adds are held-out rows of the same ``sift_like`` draw as the
corpus, as the JAX script draws them.

``--devices N`` adds the JAX script's sharded cell
(``churn_sharded_cell``): the same controller loop over ``ivf_sharded`` on
N shards, the deletes taken from the low end of the live ids (shard 0's,
by the id-rank partition) until the 1.03 imbalance trigger rebalances,
with four more checks (no new executable, a rebalance, no tombstoned id
served, recall within 0.01 of a repack of the live rows served by the
same sharded backend). The shards go on the visible cards, one each,
unless ``--shard-device`` names them (``cuda:0`` lays all N on one card).

    PYTHONPATH=src python -m repro_torch.bench.churn [--fast] [--device cpu]
        [--devices 4 --shard-device cuda:0]

prints one JSON line of results, one of checks, and the device; it writes
no file.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import churn, rotations, search
from repro_torch import device as _device
from repro_torch.bench import common
from repro_torch.core import givens
from repro_torch.data import synthetic
from repro_torch.index import ivf as index_ivf
from repro_torch.metrics import recall_at_k

FAST = dict(n=8000, dim=32, queries=64, lists=32, subspaces=8, codewords=32,
            steps=6, batch=64, nprobe=8, staging_rows=512)


def emit(name: str, **fields) -> None:
    common.emit("churn", name, **fields)


def exact_top10(Q: torch.Tensor, pool: torch.Tensor, live) -> torch.Tensor:
    """Brute-force MIPS over the live rows of ``pool`` (row = id): (b, 10)
    int64 ids. ``live`` is a bool mask over the rows."""
    live = torch.as_tensor(live, device=pool.device)
    out = []
    for s in range(0, Q.shape[0], 64):
        sc = Q[s:s + 64] @ pool.T
        sc.masked_fill_(~live[None, :], float("-inf"))
        out.append(torch.topk(sc, 10, dim=1).indices)
    return torch.cat(out)


def delta(R: torch.Tensor, sub: int, step: int):
    """The step's training delta: a ``subspace_gcd`` update of R on a
    seeded Gaussian gradient at lr 1e-3 (the JAX script's ``_delta``)."""
    g = torch.Generator(device=R.device)
    g.manual_seed(1000 + step)
    G = torch.randn(R.shape, generator=g, device=R.device)
    learner = rotations.make("subspace_gcd", sub=sub)
    _, d = learner.update(learner.init_from(R), G, 1e-3)
    return d


def state_shapes(state) -> dict:
    """Every tensor shape of an ADC state and its probe window: what the
    Engine's executables see."""
    out = {"max_blocks": state.max_blocks}
    for name, part in (("index", state.index), ("staging", state.staging)):
        if part is None:
            continue
        for f in dataclasses.fields(part):
            v = getattr(part, f.name)
            if isinstance(v, torch.Tensor):
                out[f"{name}.{f.name}"] = tuple(v.shape)
    return out


def churn_loop(engine, ctl, Q, pool, live: np.ndarray, *, steps: int,
               batch: int, next_id: int, rng: np.random.Generator,
               refresh: bool = True, on_step=None,
               low_end_removes: bool = False):
    """Balanced add/remove churn and refreshes under query load. ``live``
    (a bool mask over ``pool``'s rows) is updated in place; the adds are
    rows ``next_id`` onwards; the removes are drawn from ``rng``, or the
    ``batch`` lowest live ids with ``low_end_removes``. ``on_step(step,
    add_ids, dead)``, if given, runs after each step's search. Returns
    (per-step records, removed mask). Asserts nothing: the callers turn
    the records into checks."""
    removed = np.zeros_like(live)
    dev = pool.device
    records = []
    for step in range(steps):
        if low_end_removes:
            dead = np.nonzero(live)[0][:batch].astype(np.int32)
        else:
            dead = rng.choice(np.nonzero(live)[0], size=batch,
                              replace=False).astype(np.int32)
        add_ids = np.arange(next_id, next_id + batch, dtype=np.int32)
        add = pool[next_id:next_id + batch]
        next_id += batch

        common.sync(dev)
        t0 = time.perf_counter()
        ctl.step(add=add, add_ids=add_ids, remove_ids=dead)
        common.sync(dev)
        mut_ms = (time.perf_counter() - t0) * 1e3
        removed[dead] = True
        live[dead] = False
        live[add_ids] = True

        if refresh:
            idx = ctl.state.index
            engine.refresh(delta(idx.R, idx.quantizer.sub, step))
        ids = engine.search(Q).ids.cpu().numpy()
        got = ids[ids >= 0]
        records.append(dict(step=step, mutate_ms=mut_ms,
                            surfaced_tombstone=bool(removed[got].any()),
                            ids_live=bool(live[got].all())))
        if on_step is not None:
            on_step(step, add_ids, dead)
    return records, removed


def fresh_build_recall(Q, pool, live: np.ndarray, R, cfg, nprobe: int,
                       generator, truth) -> float:
    """Recall@10 against ``truth`` of a fresh ``ivf.build`` of the live
    rows of ``pool`` under R from ``generator``, its ids keyed back to the
    rows' ids."""
    ivf_s = search.make("ivf")
    dev = pool.device
    live_ids = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(dev)
    built = ivf_s.build(generator, pool[live_ids.long()], R, cfg,
                        device=dev).index
    ids = built.ids
    built = dataclasses.replace(built, ids=torch.where(
        ids >= 0, live_ids[torch.clamp(ids, min=0).long()], ids))
    res = ivf_s.search(search.IVF.attach(built, nprobe=nprobe), Q, k=10,
                       nprobe=nprobe)
    return recall_at_k(res.ids, truth)


def recall_oracles(engine, ctl, cfg, Q, pool, live: np.ndarray,
                   nprobe: int, generator=None) -> dict:
    """End-state recall@10 against the live set's exact top-10: the churned
    Engine's, a repack of the live rows under the same quantizers, and a
    fresh ``ivf.build`` on them (k-means anew, under the index's R) from
    ``generator``: the JAX script builds both from one key, so pass one in
    the state the churned index's build started from (default: seed 3, as
    ``run`` builds)."""
    ivf_s = search.make("ivf")
    dev = pool.device
    truth = exact_top10(Q, pool, live)
    recall_churn = recall_at_k(engine.search(Q).ids, truth)

    live_ids = torch.from_numpy(np.nonzero(live)[0].astype(np.int32))
    live_X = pool[live_ids.long().to(dev)]
    idx = ctl.state.index
    list_ids, codes = index_ivf.encode(live_X @ idx.R, idx.coarse,
                                       idx.quantizer)
    repacked = index_ivf.pack(idx.R, idx.coarse, idx.quantizer, codes,
                              list_ids, live_ids, block_size=cfg.block_size)
    res = ivf_s.search(search.IVF.attach(repacked, nprobe=nprobe), Q, k=10,
                       nprobe=nprobe)
    recall_repack = recall_at_k(res.ids, truth)

    if generator is None:
        generator = _device.generator(3, dev)
    recall_build = fresh_build_recall(Q, pool, live, idx.R, cfg, nprobe,
                                      generator, truth)
    return dict(recall_churn=recall_churn, recall_repack=recall_repack,
                recall_build=recall_build)


def checks_of(es: dict, before: dict, records: list, steps: int,
              batch: int, recalls: dict) -> dict:
    """The JAX script's seven checks. ``before`` holds the Engine's
    ``compiles`` and ``executables`` after the first search with staging
    attached; the port has no trace cache, so "zero recompiles" is no new
    executable."""
    ch = es["churn"]
    return dict(
        zero_recompiles=(es["compiles"] == before["compiles"]
                         and es["executables"] == before["executables"]),
        zero_lut_invalidations=es["lut_invalidations"] == 0,
        zero_grows=ch["grows"] == 0,
        no_tombstoned_id_surfaced=(
            not any(r["surfaced_tombstone"] for r in records)
            and all(r["ids_live"] for r in records)),
        all_mutations_exercised=(ch["flushes"] >= 1
                                 and ch["compactions"] >= 1
                                 and ch["staged"] == steps * batch
                                 and ch["tombstoned"] == steps * batch),
        recall_matches_repack=abs(recalls["recall_churn"]
                                  - recalls["recall_repack"]) <= 0.01,
        recall_within_rebuild=(recalls["recall_churn"]
                               >= recalls["recall_build"] - 0.01),
    )


def churn_sharded_cell(n: int, dim: int, queries: int, lists: int,
                       subspaces: int, codewords: int, steps: int,
                       batch: int, nprobe: int, staging_rows: int,
                       mesh) -> dict:
    """The JAX script's ``--devices`` cell on ``mesh``: controller churn
    over ``ivf_sharded`` with the low-end deletes draining shard 0 until
    the 1.03 imbalance trigger rebalances, then recall against a repack
    of the live rows under the same quantizers, served by the same
    sharded backend."""
    dev = mesh.devices[0]
    pool = synthetic.sift_like(_device.generator(0, dev), n + steps * batch,
                               dim, device=dev)
    Q = synthetic.sift_like(_device.generator(1, dev), queries, dim,
                            device=dev)
    R = givens.random_rotation(_device.generator(2, dev), dim, device=dev)
    cfg = search.SearchConfig(
        num_lists=lists, subspaces=subspaces, codewords=codewords,
        nprobe=nprobe, train_size=min(n, 16384))
    index = index_ivf.build(_device.generator(3, dev), pool[:n], R,
                            cfg.ivf_config(), train_size=cfg.train_size,
                            device=dev)
    sh_s = search.make("ivf_sharded", mesh=mesh)
    state = sh_s.attach(index, mesh=mesh, nprobe=nprobe)
    engine = search.Engine(sh_s, state, k=10, nprobe=nprobe, min_bucket=32)
    # the tight threshold makes the trigger fire within the short run
    ctl = churn.ChurnController(engine, staging_rows=staging_rows,
                                flush_at=0.5, compact_at=0.05,
                                imbalance_threshold=1.03)
    rows_before = churn.shard_rows(ctl.state)
    engine.search(Q)
    es0 = engine.stats()

    live = np.zeros(pool.shape[0], dtype=bool)
    live[:n] = True
    t0 = time.perf_counter()
    records, _ = churn_loop(engine, ctl, Q, pool, live, steps=steps,
                            batch=batch, next_id=n,
                            rng=np.random.default_rng(0), refresh=False,
                            low_end_removes=True)
    churn_s = time.perf_counter() - t0
    es = engine.stats()
    truth = exact_top10(Q, pool, live)
    recall = recall_at_k(engine.search(Q).ids, truth)

    live_ids = torch.from_numpy(np.nonzero(live)[0].astype(np.int32))
    list_ids, codes = index_ivf.encode(pool[live_ids.long().to(dev)]
                                       @ index.R, index.coarse,
                                       index.quantizer)
    repacked = index_ivf.pack(index.R, index.coarse, index.quantizer, codes,
                              list_ids, live_ids, block_size=cfg.block_size)
    res = sh_s.search(sh_s.attach(repacked, mesh=mesh, nprobe=nprobe), Q,
                      k=10, nprobe=nprobe)
    return dict(
        devices=len(mesh.devices),
        shard_devices=[str(d) for d in mesh.devices],
        recompiles=es["executables"] - es0["executables"],
        rebalances=es["churn"]["rebalances"], grows=es["churn"]["grows"],
        compactions=es["churn"]["compactions"],
        flushes=es["churn"]["flushes"],
        shard_rows_before=rows_before,
        shard_rows_after=churn.shard_rows(ctl.state),
        tombstone_clean=(not any(r["surfaced_tombstone"] for r in records)
                         and all(r["ids_live"] for r in records)),
        recall=recall, recall_repack=recall_at_k(res.ids, truth),
        churn_s=churn_s,
        mutate_ms_p50=float(np.median([r["mutate_ms"] for r in records])))


def sharded_checks(cell: dict) -> dict:
    """The JAX script's four checks of the sharded cell."""
    return dict(
        sharded_zero_recompiles=cell["recompiles"] == 0,
        sharded_rebalanced=cell["rebalances"] >= 1,
        sharded_no_tombstones=cell["tombstone_clean"],
        sharded_recall_matches_repack=abs(
            cell["recall"] - cell["recall_repack"]) <= 0.01)


def run(n: int = 50_000, dim: int = 64, queries: int = 128, lists: int = 64,
        subspaces: int = 16, codewords: int = 64, steps: int = 20,
        batch: int = 128, nprobe: int = 16, staging_rows: int = 1024,
        verbose: bool = True, devices: int = 1, device=None,
        build_seeds=(), shard_device=None):
    """The churn benchmark: (results, checks). ``device`` is the card
    unless the caller passes ``device="cpu"``. ``build_seeds`` adds a
    fresh build of the live rows from each seed to the results
    (``recall_build_by_seed``): how far the k-means draw alone moves the
    fresh build's recall, against which ``recall_within_rebuild`` holds.
    ``devices`` > 1 adds the sharded cell over ``common.shard_mesh``."""
    dev = _device.resolve(device)
    mesh = common.shard_mesh(devices, shard_device, dev) if devices > 1 \
        else None
    pool = synthetic.sift_like(_device.generator(0, dev), n + steps * batch,
                               dim, device=dev)
    Q = synthetic.sift_like(_device.generator(1, dev), queries, dim,
                            device=dev)
    R = givens.random_rotation(_device.generator(2, dev), dim, device=dev)
    cfg = search.SearchConfig(
        num_lists=lists, subspaces=subspaces, codewords=codewords,
        nprobe=nprobe, train_size=min(n, 16384), fused_refresh=True)

    ivf_s = search.make("ivf")
    t0 = time.perf_counter()
    state = ivf_s.build(_device.generator(3, dev), pool[:n], R, cfg,
                        device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0

    engine = search.Engine(ivf_s, state, k=10, nprobe=nprobe, min_bucket=32)
    ctl = churn.ChurnController(engine, staging_rows=staging_rows,
                                flush_at=0.5, compact_at=0.03)
    engine.search(Q)                      # the first search, with staging
    es0 = engine.stats()
    before = {k: es0[k] for k in ("compiles", "executables")}
    shapes0 = state_shapes(ctl.state)

    live = np.zeros(pool.shape[0], dtype=bool)
    live[:n] = True
    t0 = time.perf_counter()
    records, _ = churn_loop(engine, ctl, Q, pool, live, steps=steps,
                            batch=batch, next_id=n,
                            rng=np.random.default_rng(0))
    churn_s = time.perf_counter() - t0

    es = engine.stats()
    ch = es["churn"]
    recalls = recall_oracles(engine, ctl, cfg, Q, pool, live, nprobe)
    checks = checks_of(es, before, records, steps, batch, recalls)
    if build_seeds:
        truth = exact_top10(Q, pool, live)
        recalls["recall_build_by_seed"] = {
            seed: fresh_build_recall(Q, pool, live, ctl.state.index.R, cfg,
                                     nprobe, _device.generator(seed, dev),
                                     truth)
            for seed in build_seeds}
    results = dict(
        n=n, dim=dim, lists=lists, subspaces=subspaces, codewords=codewords,
        steps=steps, batch=batch, build_s=build_s,
        churn_qps=queries * steps / churn_s,
        mutate_ms_p50=float(np.median([r["mutate_ms"] for r in records])),
        latency_ms_p50=es["latency_ms_p50"],
        new_executables=es["executables"] - before["executables"],
        lut_invalidations=es["lut_invalidations"],
        shapes_kept=state_shapes(ctl.state) == shapes0,
        **recalls, **{k: ch[k] for k in (
            "staged", "flushed", "tombstoned", "flushes", "compactions",
            "grows", "flush_ms_p95")})
    if mesh is not None:
        cell = churn_sharded_cell(
            n=n, dim=dim, queries=queries, lists=lists, subspaces=subspaces,
            codewords=codewords, steps=steps, batch=batch, nprobe=nprobe,
            staging_rows=staging_rows, mesh=mesh)
        results["sharded"] = cell
        checks.update(sharded_checks(cell))
    if verbose:
        emit("results", **results)
        emit("checks", passed=all(checks.values()), **checks)
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--lists", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--fast", action="store_true",
                    help="the JAX script's --fast sizes")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the sharded cell (1: no cell)")
    ap.add_argument("--shard-device", default=None,
                    help="where the shards go: one device for all (cuda:0, "
                    "cpu) or a comma list of one a shard")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--build-seeds", type=int, nargs="*", default=[],
                    help="more fresh builds of the live rows, one a seed")
    args = ap.parse_args(argv)
    kw = dict(n=args.n, dim=args.dim, queries=args.queries,
              lists=args.lists, steps=args.steps, batch=args.batch)
    if args.fast:
        kw = dict(FAST)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, checks = run(devices=args.devices, device=dev,
                    build_seeds=tuple(args.build_seeds),
                    shard_device=args.shard_device, **kw)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
