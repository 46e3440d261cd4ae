"""End to end: train a ~100M-parameter two-tower retrieval model
with the paper's trainable PQ index for a few hundred steps (port of
``examples/train_twotower.py``).

Follows the paper's §3.2 protocol end to end:
  1. warm-up steps without the index layer;
  2. OPQ warm start of (R, codebooks) from a warm-up sample;
  3. joint training — codebooks by SGD (distortion loss), R by the rotation
     learner (GCD-G by default, Algorithm 2), towers by Adam — with
     asynchronous checkpoints every 100 steps and a resume from the newest
     one (kill it mid-run and start again!);
  4. final ADC-retrieval evaluation (p@50) for the learner given.

~100M params: 390k items × 256-dim table (≈100M) + tower MLPs. The run
goes under deterministic algorithms (``bench.common.deterministic``), so a
run resumed from a checkpoint ends where the straight run ends, bit for
bit, on the card too (the embedding table's gradient is an
``index_add_``, which adds in no fixed order there otherwise).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_twotower \\
          [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import device as _device
from repro_torch import rotations
from repro_torch.bench import common
from repro_torch.core import index_layer as il
from repro_torch.data import synthetic
from repro_torch.launch import train as launch
from repro_torch.models import recsys
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

LOG_EVERY = 25


def build_cfg(item_vocab: int) -> recsys.TwoTowerConfig:
    return recsys.TwoTowerConfig(
        name="twotower-100m", item_vocab=item_vocab, embed_dim=256,
        tower_dims=(256, 128), hist_len=16, scoring="cosine",
        hinge_margin=0.1,
        index=il.IndexLayerConfig(dim=128, num_subspaces=16,
                                  num_codewords=64),
        dtype=torch.float32, param_dtype=torch.float32)


@torch.no_grad()
def evaluate(model, cfg, log, k: int = 50, num_queries: int = 32) -> float:
    """p@k of ADC retrieval over every item's codes against the log's
    latent-similarity truth."""
    hist, truth = log.eval_queries(7, num_queries, cfg.hist_len, k_truth=k)
    ids = torch.arange(cfg.item_vocab, device=hist.device)
    vecs, _ = recsys.item_tower(model, ids, cfg)
    vecs = vecs / torch.clamp(torch.linalg.vector_norm(vecs, dim=-1,
                                                       keepdim=True), min=1e-6)
    codes = il.encode(model.index, vecs)
    scores = recsys.twotower_retrieve_adc(model, hist, codes, cfg)
    top = torch.argsort(-scores, dim=-1, stable=True)[:, :k].cpu().numpy()
    truth = truth.cpu().numpy()
    hits = [len(set(top[i].tolist()) & set(truth[i].tolist()))
            for i in range(len(top))]
    return sum(hits) / len(hits) / k


def run(*, steps: int = 300, warmup: int = 80, batch: int = 128,
        items: int = 390_000, ckpt_dir: str, rotation: str = "gcd_greedy",
        ckpt_every: int = 100, opq_iters: int = 30, sample: int = 2048,
        device=None) -> dict:
    """The example's run, resumed from the newest checkpoint in
    ``ckpt_dir`` if there is one; returns what it prints."""
    dev = _device.resolve(device)
    with common.deterministic():
        return _run(steps, warmup, batch, items, ckpt_dir, rotation,
                    ckpt_every, opq_iters, sample, dev)


def _run(steps, warmup, batch, items, ckpt_dir, rotation, ckpt_every,
         opq_iters, sample, dev) -> dict:
    cfg = build_cfg(items)
    model = recsys.TwoTower.init(_device.generator(0, dev), cfg, device=dev)
    n_params = sum(p.numel() for p in opt_lib.named_leaves(model).values())
    print(f"model: {n_params / 1e6:.1f}M parameters, {items} items")
    log = synthetic.ClickLog(0, cfg.item_vocab, dim=32, device=dev)
    ocfg = opt_lib.OptimizerConfig(
        lr=2e-3, total_steps=steps + warmup, warmup_steps=20,
        rotation=rotations.RotationConfig.from_spec(rotation, lr=2e-3))
    state = ts.init_state(_device.generator(1, dev), model, ocfg)

    # resume if a checkpoint exists (fault tolerance demo)
    latest = ckpt.latest_step(ckpt_dir)
    start = 0
    if latest is not None:
        restored, _ = ckpt.restore(ckpt_dir, latest,
                                   launch._ckpt_tree(state))
        state = launch._restore_state(state, restored)
        start = latest
        print(f"resumed from step {latest}")

    warm_step = ts.make_train_step(lambda p, h, i: recsys.twotower_loss(
        p, h, i, cfg, use_index=False), ocfg)
    joint_step = ts.make_train_step(lambda p, h, i: recsys.twotower_loss(
        p, h, i, cfg, use_index=True), ocfg)

    losses: dict[int, float] = {}
    loss = None
    t0 = time.perf_counter()
    for i in range(start, warmup + steps):
        hist, pos = log.batch(1000 + i, batch, cfg.hist_len)
        if i == warmup:
            # OPQ warm start of the index (paper protocol)
            with torch.no_grad():
                v, _ = recsys.item_tower(
                    model, torch.arange(sample, device=dev) % cfg.item_vocab,
                    cfg)
            model.index = il.warm_start(_device.generator(2, dev), v,
                                        cfg.index, opq_iters=opq_iters)
            print(f"[{i}] OPQ warm start done "
                  f"(distortion seeds the joint phase)")
        step_fn = warm_step if i < warmup else joint_step
        state, m = step_fn(state, hist, pos)
        loss = m["loss"]
        if i % LOG_EVERY == 0:
            losses[i] = float(loss)
            phase = "warmup" if i < warmup else "joint"
            ms = (time.perf_counter() - t0) * 1e3 / max(i - start, 1)
            print(f"step {i:4d} [{phase}] loss={losses[i]:.4f} "
                  f"({ms:.0f} ms/step)")
        if (i + 1) % ckpt_every == 0:
            ckpt.save_async(ckpt_dir, i + 1, launch._ckpt_tree(state))
    common.sync(dev)
    seconds = time.perf_counter() - t0
    ckpt.wait_pending()
    p_at_k = evaluate(model, cfg, log)
    print(f"\nfinal ADC retrieval p@50 = {p_at_k:.4f} "
          f"(rotation learner: {rotation})")
    return dict(n_params=n_params, items=items, resumed_from=latest,
                ckpt_every=ckpt_every, steps_run=warmup + steps - start,
                losses=losses,
                final_loss=None if loss is None else float(loss),
                p_at_50=p_at_k, rotation=rotation, seconds=seconds,
                ms_per_step=seconds * 1e3 / max(warmup + steps - start, 1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=80)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--items", type=int, default=390_000)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "twotower_ckpt"))
    ap.add_argument("--rotation", default="gcd_greedy",
                    choices=[n for n in rotations.names()
                             if n != "subspace_gcd"],
                    help="rotation learner (repro_torch.rotations spec)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the card)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, warmup=args.warmup, batch=args.batch,
               items=args.items, ckpt_dir=args.ckpt_dir,
               rotation=args.rotation, device=args.device)


if __name__ == "__main__":
    main()
