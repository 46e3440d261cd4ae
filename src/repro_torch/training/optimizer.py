"""AdamW with rotation-learner manifold routing (port of
``repro/training/optimizer.py``).

Ordinary parameters get AdamW exactly as the JAX package's ``_update_impl``
(``:200-272``) computes it: the global gradient norm over every leaf, the
rotations' included, clips the gradients before anything else sees them;
the moments are bias-corrected as (μ/b1c)/(√(ν/b2c) + ε); weight decay is
added to the update, not decoupled; the rate follows a cosine schedule with
a linear warm-up. This is not ``torch.optim.AdamW``, which decouples the
decay and places ε elsewhere. A leaf whose name is in ``MANIFOLD_LEAVES``
is an SO(n) rotation and goes to the learner of ``OptimizerConfig.rotation``
(GCD: Algorithm 2 through the gcd_score and givens_rotate kernels; or the
frozen control) instead.

Parameters are a dict of tensors keyed by the JAX path keys (``item_table``,
``index/R``, ...) or an ``nn.Module``, whose ``named_parameters`` give them.
``update`` works in place: the parameters, the moments in the state and the
gradients handed in are overwritten. At the paper's width the item table
and each of its gradient and moments is 3.16 GB, and JAX's fresh copies
would add three more. A leaf without a gradient (one the loss does not
reach, like the index layer during warm-up) gets a zero one, as every leaf
does under ``jax.grad``: its moments decay, weight decay moves it, and a
rotation goes through its learner all the same.

The numerical constants are rounded to float32 as the JAX package's
weak-typed float32 arithmetic rounds them. Adafactor, bf16 moments,
gradient accumulation and stacked (L, n, n) rotations wait for a later
slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import rotations as rot_lib

MANIFOLD_LEAVES = ("R", "rot_k", "rot_v")


class OptimizerConfig(NamedTuple):
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    accum_steps: int = 1
    rotation: rot_lib.RotationConfig = rot_lib.RotationConfig()


class OptState(NamedTuple):
    mu: dict[str, torch.Tensor]   # first moments (zeros for manifold leaves)
    nu: dict[str, torch.Tensor]   # second moments
    rot: dict[str, Any]           # path key -> learner state (manifold)
    step: int


def path_key(name: str) -> str:
    """The JAX path key of a parameter name: ``index.R`` -> ``index/R``."""
    return name.replace(".", "/")


def is_manifold(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in MANIFOLD_LEAVES


def named_leaves(params) -> dict[str, torch.Tensor]:
    """Parameters keyed by their JAX path keys."""
    if isinstance(params, nn.Module):
        return {path_key(n): p for n, p in params.named_parameters()}
    return dict(params)


def init(params, cfg: OptimizerConfig) -> OptState:
    leaves = named_leaves(params)
    learner = rot_lib.from_config(cfg.rotation)
    return OptState(
        mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in leaves.items()},
        nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in leaves.items()},
        rot={k: learner.init_from(p.detach().clone())
             for k, p in leaves.items() if is_manifold(k)},
        step=0)


def _f32(x) -> np.float32:
    return np.float32(x)


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """Cosine schedule with linear warm-up, in float32 as the JAX package
    computes it."""
    s = _f32(step)
    warm = min(_f32(1.0), (s + _f32(1.0)) / _f32(max(cfg.warmup_steps, 1)))
    frac = np.clip(s / _f32(max(cfg.total_steps, 1)), _f32(0.0), _f32(1.0))
    decay = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * frac))
    return float(_f32(cfg.lr) * warm * decay)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over leaves of ⟨g, g⟩), float32, on the gradients' device; one
    dot product per leaf, so no squared copy of the table is made."""
    total = None
    for g in grads.values():
        g = g.reshape(-1)
        sq = torch.dot(g, g)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _adamw_leaf(cfg, p, g, mu, nu, lr: float, b1c: float, b2c: float):
    """One AdamW leaf in place; ``g`` is the clipped gradient (consumed)."""
    b1, b2 = _f32(cfg.beta1), _f32(cfg.beta2)
    mu.mul_(float(b1)).add_(g * float(_f32(1.0) - b1))
    tmp = g * g
    nu.mul_(float(b2)).add_(tmp.mul_(float(_f32(1.0) - b2)))
    torch.div(nu, b2c, out=tmp).sqrt_().add_(float(_f32(cfg.eps)))
    upd = torch.div(mu, b1c, out=g).div_(tmp)
    if cfg.weight_decay > 0:
        upd.add_(p * float(_f32(cfg.weight_decay)))
    p.sub_(upd.mul_(lr))


def _update_impl(grads, state: OptState, params, cfg: OptimizerConfig,
                 generator: torch.Generator | None = None,
                 marks: Callable[[str], None] | None = None):
    leaves = named_leaves(params)
    step = state.step
    lr = schedule_lr(cfg, step)
    t = _f32(step + 1)
    b1c = float(_f32(1.0) - _f32(cfg.beta1) ** t)
    b2c = float(_f32(1.0) - _f32(cfg.beta2) ** t)
    learner = rot_lib.from_config(cfg.rotation)
    rot_n = dict(state.rot)
    deltas: dict[str, Any] = {}
    with torch.no_grad():
        grads = {k: grads[k] if k in grads else torch.zeros_like(p)
                 for k, p in leaves.items()}
        clip = None
        if cfg.grad_clip > 0:
            clip = torch.clamp(
                cfg.grad_clip / torch.clamp(global_norm(grads), min=1e-9),
                max=1.0)

        def clipped(k):
            g = grads[k]
            return g.mul_(clip) if clip is not None else g

        for k, g in grads.items():
            if not is_manifold(k):
                _adamw_leaf(cfg, leaves[k], clipped(k), state.mu[k],
                            state.nu[k], lr, b1c, b2c)
        if marks is not None:
            marks("adamw")
        for k in grads:
            if is_manifold(k):
                p = leaves[k]
                st = learner.with_rotation(state.rot[k], p.detach())
                st2, delta = learner.update(st, clipped(k),
                                            cfg.rotation.lr, generator)
                p.copy_(learner.materialize(st2))
                rot_n[k] = st2
                deltas[k] = delta
        if marks is not None:
            marks("rotation")
    return params, OptState(mu=state.mu, nu=state.nu, rot=rot_n,
                            step=step + 1), deltas


def update(grads: dict[str, torch.Tensor], state: OptState, params,
           cfg: OptimizerConfig, generator: torch.Generator | None = None,
           marks: Callable[[str], None] | None = None):
    """(params, state) after one step: clip the global gradient norm, then
    AdamW on every leaf but the SO(n) ones, which go through the configured
    rotation learner. In place (see the module docstring). ``marks``, if
    given, is called with "adamw" and "rotation" after each part."""
    p_n, state_n, _deltas = _update_impl(grads, state, params, cfg,
                                         generator, marks)
    return p_n, state_n


def update_with_deltas(grads: dict[str, torch.Tensor], state: OptState,
                       params, cfg: OptimizerConfig,
                       generator: torch.Generator | None = None,
                       marks: Callable[[str], None] | None = None):
    """``update`` that also returns ``{path key: RotationDelta}`` for the
    manifold leaves, for a live index to absorb."""
    return _update_impl(grads, state, params, cfg, generator, marks)
