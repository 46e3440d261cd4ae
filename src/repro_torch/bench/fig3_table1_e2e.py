"""Fig 3 + Table 1 of the paper on the port (port of
``benchmarks/fig3_table1_e2e.py``).

Paper §3.2 protocol at the JAX script's sizes: the two-tower retrieval
model (cosine scoring, hinge margin 0.1) on a synthetic click log with
known ground truth. Warm-up steps without the index layer, an OPQ warm
start of (R, codebooks) with ``OPQ_ITERS`` (30) iterations, then joint
steps where R moves by each rotation learner of the paper's Table 1:

  frozen | cayley_sgd | gcd_random | gcd_greedy | gcd_steepest

Every row goes through ``training.optimizer``; the learner is only
``OptimizerConfig.rotation``. Reported per row: the quantisation
distortion of fresh item-tower outputs (Fig 3), p@50 / r@50 of ADC
retrieval against the latent-similarity truth (Table 1), ‖R − R_warm‖_F
and the row's seconds. The five checks and their tolerances are the JAX
script's.

The JAX script runs the warm-up and the warm start again for every row,
from the same key, and so gives every row the same warm start. Here they
run once and each row starts from a copy of their result, the same warm
start at a fifth of the cost. Each row gets its own ``torch.Generator``
(GCD-R draws its pairs from it), made from the seed on the run's device.

``run()`` runs under ``torch.use_deterministic_algorithms(True)``, as XLA
runs the JAX script: on the card the embedding tables' gradient
(``index_add_``) otherwise sums in no fixed order, and two runs of one
seed then differ by more than the gaps the checks compare. So a seed
gives one answer on a given card and software stack.

    PYTHONPATH=src python -m repro_torch.bench.fig3_table1_e2e \
        [--seed S] [--device cpu]

runs it at the JAX script's default sizes and prints one JSON line per row
and per check, then the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import rotations
from repro_torch.bench import common
from repro_torch.configs import paper_twotower
from repro_torch.core import index_layer as il
from repro_torch.data import synthetic
from repro_torch.models import recsys
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

# the paper's Table 1 rows, in the registry's order
METHODS = [m for m in rotations.names()
           if m in ("frozen", "cayley_sgd", "gcd_random", "gcd_greedy",
                    "gcd_steepest")]
# manifold lr per learner: the Cayley pull-back rescales the gradient
# (about 2× the GCD directional derivatives), so it takes a smaller step
ROT_LRS = {"cayley_sgd": 1e-3}
OPQ_ITERS = 30         # the warm start's OPQ iterations
ORDER_SLACK = 1.05     # the ordering checks' tolerance
GCD_ROWS = ("gcd_random", "gcd_greedy", "gcd_steepest")


def emit(name: str, **fields) -> None:
    common.emit("fig3_table1", name, **fields)


def _retrieval_metrics(model, cfg, log, k=100, num_queries=64):
    """p@k and r@k of ADC retrieval over the whole corpus's codes."""
    hist, truth = log.eval_queries(7, num_queries, cfg.hist_len, k_truth=k)
    with torch.no_grad():
        ids = torch.arange(cfg.item_vocab, device=log.device)
        vecs, _ = recsys.item_tower(model, ids, cfg)
        vecs = vecs / torch.clamp(torch.linalg.vector_norm(
            vecs, dim=-1, keepdim=True), min=1e-6)
        codes = il.encode(model.index, vecs)
        scores = recsys.twotower_retrieve_adc(model, hist, codes, cfg)
    top = torch.topk(scores, k, dim=1).indices
    hits = (top[:, :, None] == truth[:, None, :]).any(-1).sum(1).double()
    return float(hits.mean()) / k, float(hits.mean()) / truth.shape[1]


def _opt_cfg(method: str, steps: int) -> opt_lib.OptimizerConfig:
    return opt_lib.OptimizerConfig(
        lr=3e-3, total_steps=steps, warmup_steps=10,
        rotation=rotations.RotationConfig(method,
                                          lr=ROT_LRS.get(method, 3e-3)))


def checks_of(results: dict) -> dict:
    """The JAX script's five checks (``fig3_table1_e2e.py:120-136``)."""
    return {
        "trainable_beats_frozen": min(
            results[m]["distortion"] for m in GCD_ROWS)
        < results["frozen"]["distortion"],
        "greedy_le_random": results["gcd_greedy"]["distortion"]
        <= results["gcd_random"]["distortion"] * ORDER_SLACK,
        "steepest_le_greedy": results["gcd_steepest"]["distortion"]
        <= results["gcd_greedy"]["distortion"] * ORDER_SLACK,
        "cayley_r_trains": results["cayley_sgd"]["dR_from_warmstart"] > 1e-4,
        "frozen_r_stays": results["frozen"]["dR_from_warmstart"] < 1e-6,
    }


def margins_of(results: dict) -> dict:
    """How far each distortion check is from flipping, as a fraction of
    the distortion it is held against: the ordering checks' slack left of
    ORDER_SLACK, and the best GCD row below frozen (negative: failed)."""
    d = {m: r["distortion"] for m, r in results.items()}
    return {
        "trainable_beats_frozen":
            1.0 - min(d[m] for m in GCD_ROWS) / d["frozen"],
        "greedy_le_random":
            ORDER_SLACK - d["gcd_greedy"] / d["gcd_random"],
        "steepest_le_greedy":
            ORDER_SLACK - d["gcd_steepest"] / d["gcd_greedy"],
    }


def run(steps=250, warmup=40, batch=64, seed=0, verbose=True,
        item_vocab=1024, *, device=None):
    """The five rows and the five checks: (results, checks). ``device``
    is the card unless the caller passes ``device="cpu"``."""
    with common.deterministic():
        return _run(steps, warmup, batch, seed, verbose, item_vocab,
                    _device.resolve(device))


def _run(steps, warmup, batch, seed, verbose, item_vocab, dev):
    cfg = paper_twotower.make_smoke()._replace(item_vocab=item_vocab)
    log = synthetic.ClickLog(seed, cfg.item_vocab, dim=32, device=dev)
    g = _device.generator(seed, dev)

    # Phase 1: warm-up without the index layer (paper: 10k steps, scaled)
    model = recsys.TwoTower.init(g, cfg._replace(index=None), device=dev)
    wcfg = _opt_cfg("frozen", steps)
    warm_step = ts.make_train_step(lambda p, h, pos: recsys.twotower_loss(
        p, h, pos, cfg, use_index=False), wcfg)
    state = ts.init_state(None, model, wcfg)
    for i in range(warmup):
        h, pos = log.batch(1000 + i, batch, cfg.hist_len)
        state, _ = warm_step(state, h, pos)

    # Phase 2: OPQ warm start of (R, codebooks) on a sample of item vectors
    sample_ids = torch.arange(min(1024, cfg.item_vocab), device=dev)
    with torch.no_grad():
        v, _ = recsys.item_tower(model, sample_ids, cfg)
    model.index = il.warm_start(g, v, cfg.index, opq_iters=OPQ_ITERS)
    start = {k: p.detach().clone()
             for k, p in opt_lib.named_leaves(model).items()}

    def joint_loss(p, h, pos):
        return recsys.twotower_loss(p, h, pos, cfg, use_index=True)

    # Phase 3: joint training from the warm start, R moved by each learner
    results = {}
    for method in METHODS:
        with torch.no_grad():
            for k, p in opt_lib.named_leaves(model).items():
                p.copy_(start[k])
        common.sync(dev)
        t0 = time.perf_counter()
        ocfg = _opt_cfg(method, steps)
        step = ts.make_train_step(joint_loss, ocfg)
        state = ts.init_state(_device.generator(seed + 1, dev), model, ocfg)
        for i in range(steps):
            h, pos = log.batch(2000 + i, batch, cfg.hist_len)
            state, _ = step(state, h, pos)
        R = model.index.R.detach()
        with torch.no_grad():
            v, _ = recsys.item_tower(model, sample_ids, cfg)
            dist = float(il.quantizer(model.index).distortion(v @ R))
        p_at, r_at = _retrieval_metrics(model, cfg, log, k=50)
        dR = float(torch.linalg.matrix_norm(R - start["index/R"]))
        common.sync(dev)
        results[method] = {"distortion": dist, "p@50": p_at, "r@50": r_at,
                           "dR_from_warmstart": dR,
                           "seconds": time.perf_counter() - t0}
        if verbose:
            emit(f"table1/{method}", **results[method])

    checks, margins = checks_of(results), margins_of(results)
    if verbose:
        for k, ok in checks.items():
            emit(f"table1/check/{k}", passed=ok, margin=margins.get(k))
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    run(seed=args.seed, device=dev)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
