"""Fault-tolerant training launcher (port of ``repro/launch/train.py``).

Wires together: the config registry → the synthetic pipeline → the train
step (AdamW + the manifold learner on every rotation leaf) → checkpoints
→ auto-resume. The contract is the JAX launcher's:
  * checkpoints are atomic and manifest-gated (``training.checkpoint``); a
    crash mid-save leaves an ignorable partial directory;
  * ``resume`` (the default) restores the newest complete checkpoint and
    the pipeline's cursor, so a restarted job replays no batch twice and
    ends where an uninterrupted one ends;
  * a step watchdog flags stragglers: a step longer than
    ``watchdog_factor`` × the median of the last 64 is printed and counted
    (``train.straggler_steps``).

Every architecture of the registry trains: ``lm`` (the transformer, dense
or MoE: grok-1, llama4-maverick), ``gnn`` (GraphSAGE on minibatch blocks of
a 2,000-node synthetic graph, as the JAX launcher builds it) and the
recommenders (Wide&Deep, the two-tower model, MIND, DIN). The batches are
the JAX launcher's: (batch, 128) LM tokens, ``sample_blocks`` of ``batch``
seeds at the config's fanout, ``ctr_batch``, the click log's batches (two
tower, MIND) and ``din_batch``. The JAX launcher trains every family with
AdamW (``launch.cells._opt_cfg_for`` picks Adafactor above 50B parameters
for the full-size cells).

The step runs on the card unless ``device="cpu"``. The parameters come
from a generator seeded with ``seed``, the learner's from ``(seed << 32) |
1`` (the counterpart of ``fold_in(PRNGKey(seed), 1)``). A checkpoint holds
``(TrainState, pipeline cursor)`` under the JAX package's path keys, the
learner generator's state in ``0/rng``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 8 [--full] [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import configs, obs, rotations
from repro_torch import device as _device
from repro_torch.data import graph as graph_lib
from repro_torch.data import pipeline as pipe_lib
from repro_torch.data import synthetic
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

LM_SEQ = 128
#: the JAX launcher's GNN graph: nodes, average degree (seed 0)
GNN_GRAPH = (2000, 8)

#: the recommenders' parameter modules, by config type
_RECSYS = {recsys.WideDeepConfig: recsys.WideDeep,
           recsys.TwoTowerConfig: recsys.TwoTower,
           recsys.MINDConfig: recsys.MIND, recsys.DINConfig: recsys.DIN}


def _draw_seed(g: torch.Generator) -> int:
    return int(torch.randint(0, 1 << 30, (), generator=g, device=g.device))


def make_batch_fn(cfg, family: str, batch: int, *, device=None):
    """The family's synthetic batch: generator -> tuple of tensors on the
    generator's device. ``device`` (the card by default) holds the GNN
    graph's features, uploaded once; the generator must be on it."""
    if family == "lm":
        def f(g):
            return synthetic.lm_batch(g, batch, LM_SEQ, cfg.vocab_size)
        return f
    if family == "gnn":
        graph = graph_lib.synthetic_graph(0, *GNN_GRAPH, cfg.d_in,
                                          num_classes=cfg.num_classes)
        feats = torch.from_numpy(graph.feats).to(_device.resolve(device))

        def f(g):
            seed = _draw_seed(g)
            seeds = np.random.RandomState(seed).randint(
                0, graph.num_nodes, size=batch)
            blocks, labels = graph_lib.sample_blocks(
                graph, seeds, cfg.sample_sizes, seed, feats)
            return (*blocks, labels)
        return f
    if isinstance(cfg, recsys.WideDeepConfig):
        def f(g):
            return synthetic.ctr_batch(g, batch, cfg.n_sparse,
                                       cfg.vocab_per_field)
        return f
    if isinstance(cfg, (recsys.TwoTowerConfig, recsys.MINDConfig)):
        log = synthetic.ClickLog(0, cfg.item_vocab, dim=32, device="cpu")

        def f(g):
            hist, pos = log.batch(_draw_seed(g), batch, cfg.hist_len)
            dev = torch.device(g.device)
            return hist.to(dev), pos.to(dev)
        return f
    if isinstance(cfg, recsys.DINConfig):
        def f(g):
            return synthetic.din_batch(g, batch, cfg.hist_len,
                                       cfg.item_vocab)
        return f
    raise TypeError(type(cfg))


def make_loss_fn(cfg, family: str):
    if family == "lm":
        return lambda p, tok, lab: tfm.forward_train(p, tok, lab, cfg)
    if family == "gnn":
        return lambda p, *b: gnn.loss_minibatch(p, list(b[:-1]), b[-1], cfg)
    if isinstance(cfg, recsys.WideDeepConfig):
        return lambda p, ids, lab: recsys.widedeep_loss(p, ids, lab, cfg)
    if isinstance(cfg, recsys.TwoTowerConfig):
        return lambda p, h, pos: recsys.twotower_loss(p, h, pos, cfg)
    if isinstance(cfg, recsys.MINDConfig):
        return lambda p, h, pos: recsys.mind_loss(p, h, pos, cfg)
    if isinstance(cfg, recsys.DINConfig):
        return lambda p, h, t, lab: recsys.din_loss(p, h, t, lab, cfg)
    raise TypeError(type(cfg))


def init_model(generator: torch.Generator, cfg, family: str, *,
               device=None):
    """Fresh trainable parameters on ``device`` (the card by default): the
    transformer's nested dict with every leaf requiring grad, or the
    model's ``nn.Module`` (GraphSAGE, a recommender)."""
    if family == "lm":
        params = tfm.init_params(generator, cfg, device=device)
        for leaf in opt_lib.named_leaves(params).values():
            leaf.requires_grad_(True)
        return params
    if family == "gnn":
        return gnn.GraphSAGE.init(generator, cfg, device=device)
    if type(cfg) in _RECSYS:
        return _RECSYS[type(cfg)].init(generator, cfg, device=device)
    raise TypeError(type(cfg))


def _rotation_health(params) -> float | None:
    """Max orthogonality error, in float32, over the manifold (SO(n))
    leaves, a stacked (L, n, n) leaf layer by layer: the trainer-side twin
    of ``maintain.refresh_health``'s drift gauge. One host sync a call;
    callers gate on ``obs.enabled()``."""
    errs = []
    for k, leaf in opt_lib.named_leaves(params).items():
        if (opt_lib.is_manifold(k) and leaf.dim() >= 2
                and leaf.shape[-1] == leaf.shape[-2]):
            n = leaf.shape[-1]
            for r in leaf.detach().float().reshape(-1, n, n):
                errs.append(float(rotations.orthogonality_error(r)))
    return max(errs) if errs else None


def _ckpt_tree(state: ts.TrainState):
    """The checkpointed form of a TrainState: the generator as its state
    (a uint8 tensor), everything else as it is."""
    rng = None if state.rng is None else state.rng.get_state()
    return state._replace(rng=rng)


def _restore_state(state: ts.TrainState, restored: ts.TrainState
                   ) -> ts.TrainState:
    """``state`` with the restored leaves: a dict of parameters replaced
    (every leaf requiring grad again), a module's parameters copied into
    it, the learner's generator set to its saved state."""
    params = state.params
    if isinstance(params, torch.nn.Module):
        with torch.no_grad():
            for k, p in opt_lib.named_leaves(params).items():
                p.copy_(restored.params[k])
    else:
        params = restored.params
        for leaf in opt_lib.named_leaves(params).values():
            leaf.requires_grad_(True)
    if state.rng is not None:
        state.rng.set_state(restored.rng)
    return ts.TrainState(params=params, opt_state=restored.opt_state,
                         step=restored.step, rng=state.rng)


def train(arch_id: str, steps: int, batch: int, ckpt_dir: str | None,
          resume: bool = True, full: bool = False, seed: int = 0,
          ckpt_every: int = 50, watchdog_factor: float = 5.0,
          rotation: str = "gcd_greedy", log_every: int = 10,
          stop_after: int | None = None, obs_log: str | None = None,
          prefetch: bool = False, live_loop=None, *, device=None):
    """Train ``arch_id`` (its full config with ``full``, else its smoke
    config) for ``steps`` steps of ``batch``. Returns (state, the loss of
    each step run).

    ``stop_after``: checkpoint and return after that many steps, a
    simulated crash (the schedule still targets ``steps``, so a resumed run
    ends where an uninterrupted one does). ``obs_log``: enable the global
    ``repro_torch.obs`` registry with a JSONL event log at that path (the
    spans, gauges and events of the JAX launcher, under its names).
    ``prefetch``: make batch k + 1 on a worker thread while step k runs
    (the same stream; the cursor in a checkpoint is the same either way).
    ``live_loop``: a ``repro_torch.pipeline.LiveIndexLoop``; the step then
    emits its rotation deltas and the loop's ``on_step`` runs after each
    step, ``drain`` at the end."""
    dev = _device.resolve(device)
    if obs_log:
        obs.enable(jsonl=obs_log)
    reg = obs.default_registry()
    arch = configs.get(arch_id)
    cfg = arch.make_config() if full else arch.make_smoke()
    loss_fn = make_loss_fn(cfg, arch.family)
    batch_fn = make_batch_fn(cfg, arch.family, batch, device=dev)

    ocfg = opt_lib.OptimizerConfig(
        lr=1e-3, total_steps=steps, warmup_steps=min(50, steps // 10 + 1),
        rotation=rotations.RotationConfig.from_spec(rotation))
    params = init_model(_device.generator(seed, dev), cfg, arch.family,
                        device=dev)
    state = ts.init_state(_device.generator((seed << 32) | 1, dev), params,
                          ocfg)
    pipe = pipe_lib.Pipeline(batch_fn, seed=seed, prefetch=prefetch,
                             registry=reg, device=dev)

    start_step = 0
    if ckpt_dir and resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            (restored, pipe_state), _ = ckpt.restore(
                ckpt_dir, latest, (_ckpt_tree(state), pipe.state()))
            state = _restore_state(state, restored)
            pipe.restore(pipe_state)
            start_step = latest
            print(f"[train] resumed from step {latest}")

    step_fn = ts.make_train_step(loss_fn, ocfg,
                                 emit_deltas=live_loop is not None)
    times: list[float] = []
    metrics_hist: list[float] = []
    metrics: dict = {}
    for i in range(start_step, steps):
        t0 = time.perf_counter()
        with reg.span("train.step"):
            batch_data = next(pipe)
            state, metrics = step_fn(state, *batch_data)
            loss = float(metrics["loss"])   # syncs: the span covers compute
        if live_loop is not None:
            live_loop.on_step(metrics)
        dt = time.perf_counter() - t0
        times.append(dt)
        metrics_hist.append(loss)
        if obs.enabled():
            reg.distribution("train.step_ms").observe(dt * 1e3)
            reg.gauge("train.loss").set(loss)
            reg.gauge("train.grad_norm").set(float(metrics["grad_norm"]))
        if len(times) > 8:
            med = statistics.median(times[-64:])
            if dt > watchdog_factor * med:
                print(f"[watchdog] step {i} straggled: {dt:.2f}s vs median "
                      f"{med:.2f}s")
                reg.counter("train.straggler_steps").inc()
        if i % log_every == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if obs.enabled():
                health = _rotation_health(state.params)
                if health is not None:
                    reg.gauge("train.rotation_orthogonality").set(health)
                reg.event("train_step", step=i, loss=loss,
                          grad_norm=float(metrics["grad_norm"]),
                          step_ms=dt * 1e3, rotation_orthogonality=health)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt.save_async(ckpt_dir, i + 1, (_ckpt_tree(state), pipe.state()),
                            metadata={"arch": arch_id, "loss": loss})
        if stop_after is not None and (i + 1) >= stop_after:
            if ckpt_dir:
                ckpt.wait_pending()
                ckpt.save(ckpt_dir, i + 1, (_ckpt_tree(state), pipe.state()),
                          metadata={"arch": arch_id, "crashed": True})
            print(f"[train] simulated crash after step {i + 1}")
            pipe.close()
            return state, metrics_hist
    if live_loop is not None:
        live_loop.drain()
    pipe.close()
    if ckpt_dir:
        ckpt.wait_pending()
        ckpt.save(ckpt_dir, steps, (_ckpt_tree(state), pipe.state()),
                  metadata={"arch": arch_id, "final": True})
    return state, metrics_hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--rotation", default="gcd_greedy",
                    choices=[n for n in rotations.names()
                             if n != "subspace_gcd"])
    ap.add_argument("--obs-log", default=None,
                    help="enable repro_torch.obs and stream step events to "
                         "this JSONL file; a metrics report prints at exit")
    ap.add_argument("--prefetch", action="store_true",
                    help="make the next batch on a worker thread (the same "
                         "stream)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the "
                         "card)")
    args = ap.parse_args(argv)
    _, hist = train(args.arch, args.steps, args.batch, args.ckpt_dir,
                    resume=not args.no_resume, full=args.full,
                    rotation=args.rotation, obs_log=args.obs_log,
                    prefetch=args.prefetch, device=args.device)
    if hist:
        print(f"final loss: {hist[-1]:.4f} (start {hist[0]:.4f})")
    if args.obs_log:
        print(obs.report())


if __name__ == "__main__":
    main()
