"""Joint training steps of the paper's two-tower model with the trainable
PQ index layer, through ``repro_torch.training.train_state.make_train_step``
(``models.recsys.twotower_loss`` with the index layer, AdamW, and the
rotation learner the traffic names).

Set-up (from the seed): the click log and a pool of batches drawn from it
at set-up; the weights, drawn on the card (table 0.01·N(0, 1), tower
weights N(0, 1/fan-in), biases 0, R a random rotation, each subspace's
codebook the rotated item-tower outputs of K random items). The one train
state is built, driven through its first ``checked_steps`` steps on the
pool's first batches (the window's own call and feed), then
``warmup_steps`` more, and handed to the window, which cycles the pool.

After the window: the plain reference of ``reference/twotower.py`` runs
the checked steps again from the same weights and batches. Compared: the
first step's loss; each Adam leaf's first gradient as the optimizer got it (its
first moment after step 1, over 1 − β1); each leaf's change after the
checked steps. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change (they move by round-off).

Traffic keys: ``pool_batches``, ``cand``, ``rotation``,
``checked_steps``, ``warmup_steps``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import twotower as ref
from perfbench.traffic.clicklog import ClickLog
from perfbench.work import peaks
from perfbench.work import train as work

#: reference gradient, as a share of the median leaf's, below which a
#: leaf's change is round-off
STILL = 1e-3


def model_spec(cfg: dict) -> dict:
    ix = cfg["index"]
    return dict(tower_dims=tuple(cfg["tower_dims"]),
                hinge_margin=cfg["hinge_margin"],
                distortion_weight=ix["distortion_weight"])


def make_weights(cell: harness.Cell, cfg: dict) -> dict:
    """The starting weights, on the card, in a few large draws."""
    g = cell.generator("weights")
    dev = cell.device
    e, towers = cfg["embed_dim"], cfg["tower_dims"]
    n, D, K = cfg["index"]["dim"], cfg["index"]["num_subspaces"], \
        cfg["index"]["num_codewords"]
    p = {"item_table": 0.01 * torch.randn((cfg["item_vocab"], e),
                                          generator=g, device=dev)}
    dims = (e, *towers)
    for prefix in ("user", "item"):
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            p[f"{prefix}{i}_w"] = torch.randn((a, b), generator=g,
                                              device=dev) / a ** 0.5
            p[f"{prefix}{i}_b"] = torch.zeros(b, device=dev)
    R, _ = torch.linalg.qr(torch.randn((n, n), generator=g, device=dev))
    p[ref.MANIFOLD] = R.contiguous()
    with torch.no_grad():
        ids = torch.randint(0, cfg["item_vocab"], (K,), generator=g,
                            device=dev)
        v = ref._mlp(p, p["item_table"][ids], "item", len(towers),
                     torch.matmul) @ R
    p["index/codebooks"] = v.reshape(K, D, n // D).transpose(0, 1) \
        .contiguous()
    return p


def program_model(p: dict, cfg: dict):
    """The program's model over copies of the weights, and its config."""
    from repro_torch.core import index_layer as il
    from repro_torch.models import recsys

    ix = cfg["index"]
    tensors = {k: v.clone() for k, v in p.items() if not k.startswith(
        "index/")}
    layer = il.IndexLayer(p[ref.MANIFOLD].clone(),
                          p["index/codebooks"].clone())
    tcfg = recsys.TwoTowerConfig(
        name=cfg["name"], item_vocab=cfg["item_vocab"],
        embed_dim=cfg["embed_dim"], tower_dims=tuple(cfg["tower_dims"]),
        hist_len=cfg["hist_len"], scoring=cfg["scoring"],
        hinge_margin=cfg["hinge_margin"],
        index=il.IndexLayerConfig(ix["dim"], ix["num_subspaces"],
                                  ix["num_codewords"],
                                  ix["distortion_weight"]),
        dtype=torch.float32, param_dtype=torch.float32)
    return recsys.TwoTower(tensors, layer), tcfg


class Marks:
    """CUDA events at the step's marks (``make_train_step``'s ``marks``)."""

    def __init__(self):
        self.steps: list = []

    def start(self) -> None:
        self.steps.append([])
        self("start")

    def __call__(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((name, ev))

    def spans_ms(self) -> dict:
        """{part: [ms of each step]}, each part from the mark before."""
        out: dict[str, list] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                out.setdefault(name, []).append(a.elapsed_time(b))
        return out


def gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / max(abs(want), scale, 1e-30)


def worst(got: dict, want: dict, keys) -> float:
    """The worst leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    keys = list(keys)
    med = float(np.median([want[k] for k in keys]))
    return max(gap(got[k], want[k], med) for k in keys)


def setup_inputs(cell: harness.Cell):
    """The pool of batches and the starting weights, on the card."""
    cfg, t = cell.config, cell.workload["traffic"]
    log = ClickLog(cell.generator("clicks"), cfg["item_vocab"],
                   dim=cfg["click_dim"])
    pool = [tuple(torch.from_numpy(x).to(cell.device) for x in log.batch(
        cell.numpy_seed(f"batch{i}"), cfg["train_batch"], cfg["hist_len"],
        t["cand"])) for i in range(t["pool_batches"])]
    return pool, make_weights(cell, cfg)


def reference(cell: harness.Cell, weights: dict, pool,
              precision: str = "float32") -> dict:
    """The reference's checked steps from ``weights`` on the pool's first
    batches."""
    t = cell.workload["traffic"]
    return ref.train(weights, pool[:t["checked_steps"]],
                     model_spec(cell.config),
                     dict(cell.config["optimizer"],
                          rotation_method=t["rotation"].split("_", 1)[1]),
                     cell.generator("pairs"), cell.device, precision)


def compare(got: dict, want: dict) -> dict:
    """The numbers held to the cell's limits: the first step's loss gap,
    and the worst leaf's gap of first-gradient norms (Adam leaves) and of
    change norms (leaves the reference's gradient moves). The later steps'
    losses are not compared: Adam's first update moves an element by ±lr
    whatever its gradient's size, so an element whose gradient is at
    rounding level moves either way on either side, and the loss gaps of
    steps 2 and 3 swing from seed to seed where the first step's do not."""
    grads = want["grad_norms"]
    med = float(np.median(list(grads.values())))
    return dict(
        loss_gap=gap(got["losses"][0], want["losses"][0], 0.0),
        grad_norm_gap=worst(got["grad_norms"], grads,
                            [k for k in grads if k != ref.MANIFOLD]),
        change_norm_gap=worst(got["change_norms"], want["change_norms"],
                              [k for k, v in grads.items()
                               if v >= STILL * med]))


def run(cell: harness.Cell) -> dict:
    from repro_torch import rotations
    from repro_torch.models import recsys
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    cfg, t = cell.config, cell.workload["traffic"]
    o = cfg["optimizer"]
    B, H = cfg["train_batch"], cfg["hist_len"]
    pool, p0 = setup_inputs(cell)
    model, tcfg = program_model(p0, cfg)
    host0 = {k: torch.empty(v.shape, pin_memory=v.is_cuda).copy_(v)
             for k, v in p0.items()}
    del p0
    ocfg = opt_lib.OptimizerConfig(
        lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"],
        weight_decay=0.0, grad_clip=o["grad_clip"], warmup_steps=1,
        total_steps=1, schedule="constant",
        rotation=rotations.RotationConfig(t["rotation"], lr=o["rotation_lr"]))
    marks = Marks() if cell.trace and cell.device.type == "cuda" else None
    step = ts.make_train_step(lambda p, h, pos: recsys.twotower_loss(
        p, h, pos, tcfg, use_index=True), ocfg, marks=marks)
    state = ts.init_state(cell.generator("pairs"), model, ocfg)

    def take(state, batch):
        if marks is not None:
            marks.start()
        return step(state, *batch)

    checked = t["checked_steps"]
    losses, grad0 = [], {}
    for i in range(checked):
        state, m = take(state, pool[i])
        losses.append(m["loss"])
        if i == 0:
            grad0 = {k: float(torch.linalg.vector_norm(mu)) / (1 - o["beta1"])
                     for k, mu in state.opt_state.mu.items()
                     if k != ref.MANIFOLD}
    leaves = opt_lib.named_leaves(state.params)
    change = {k: float(torch.linalg.vector_norm(p.detach() - host0[k].to(
        p.device))) for k, p in leaves.items()}
    losses = [float(x) for x in losses]
    for i in range(checked, checked + t["warmup_steps"]):
        state, _ = take(state, pool[i % len(pool)])

    window_losses = []
    if marks is not None:
        marks.steps = []
    with cell.window() as t0:
        i = checked + t["warmup_steps"]
        deadline = t0 + cell.seconds
        while time.perf_counter() < deadline:
            state, m = take(state, pool[i % len(pool)])
            window_losses.append(m["loss"])
            i += 1
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    spans = marks.spans_ms() if marks is not None else {}
    del state, model, step, leaves, m
    harness.free()

    want = reference(cell, host0, pool)
    got = dict(losses=losses, grad_norms=grad0, change_norms=change)
    for name, value in compare(got, want).items():
        cell.check(name, value, cell.limit(name))

    window_s = cell.window_s
    ix = cfg["index"]
    P = work.trainable_elements(cfg["item_vocab"], cfg["embed_dim"],
                                tuple(cfg["tower_dims"]),
                                ix["num_codewords"], ix["dim"])
    flops = steps * work.step_flops(B, H, cfg["embed_dim"],
                                    tuple(cfg["tower_dims"]), ix["dim"],
                                    ix["num_codewords"], P)
    nbytes = steps * work.step_bytes(P)
    return dict(attempted=steps, failed=failed,
                e2e=dict(train_examples_per_s=steps * B / window_s),
                host=dict(steps=steps), marks=spans,
                work=dict(flops=flops, bytes=nbytes),
                card=dict(steps=steps, batch=B,
                          mfu_bound=peaks.bound_s(flops, nbytes)[1],
                          losses=losses, reference_losses=want["losses"]))


def control(cell: harness.Cell, fault: str | None = None) -> dict:
    """The numbers the control reads: the reference's checked steps in TF32
    in the program's place, held to the float32 reference. With
    ``fault="half_batch"`` the reference in the program's place trains on
    the first half of each batch instead (in float32)."""
    pool, weights = setup_inputs(cell)
    if fault == "half_batch":
        half = [(h[:h.shape[0] // 2], p[:p.shape[0] // 2]) for h, p in pool]
        got = reference(cell, weights, half)
    elif fault is None:
        got = reference(cell, weights, pool, "tf32")
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return compare(got, reference(cell, weights, pool))
