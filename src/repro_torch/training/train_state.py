"""Train state and the train-step builder (port of
``repro/training/train_state.py``).

``make_train_step(loss_fn, opt_cfg)`` turns ``loss_fn(params, *batch)`` into
a ``(state, *batch) -> (state, metrics)`` step that differentiates the loss
(the rotation ``R`` included: its gradient feeds the rotation learner) and
applies ``training.optimizer`` (AdamW plus the manifold learner). PyTorch
runs eagerly, so there is nothing to jit; the step updates the parameters
in place (see ``training.optimizer``).

``eq1_loss`` is the paper's Eq. (1) for any quantizer with ``encode_st``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training import optimizer as opt_lib


def eq1_loss(quantizer, R: torch.Tensor, X: torch.Tensor,
             task_loss: Callable[[torch.Tensor], torch.Tensor],
             distortion_weight: float = 1.0) -> torch.Tensor:
    """L_task(T(X)) + w·(1/m)‖XR − φ(XR)‖² with T(X) = φ(XR)Rᵀ; φ is bridged
    by its straight-through ``encode_st``."""
    XR = X @ R
    tx = quantizer.encode_st(XR) @ R.T
    return task_loss(tx) + distortion_weight * quantizer.distortion(XR)


class TrainState(NamedTuple):
    params: Any                      # an nn.Module (or a dict of tensors)
    opt_state: opt_lib.OptState
    step: int
    rng: torch.Generator | None      # handed to the rotation learner


def init_state(generator: torch.Generator | None, params,
               opt_cfg: opt_lib.OptimizerConfig) -> TrainState:
    return TrainState(params=params, opt_state=opt_lib.init(params, opt_cfg),
                      step=0, rng=generator)


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    opt_cfg: opt_lib.OptimizerConfig,
                    emit_deltas: bool = False,
                    marks: Callable[[str], None] | None = None) -> Callable:
    """loss_fn(params, *batch) -> scalar. Returns the step function.

    ``emit_deltas=True`` adds ``metrics["rotation_deltas"]``, the
    ``{path key: RotationDelta}`` each manifold update applied. ``marks``,
    if given, is called with "forward", "backward", "adamw" and "rotation"
    as each part of the step has been enqueued (``chip_smoke.py`` records a
    CUDA event there). Gradient accumulation (``accum_steps > 1``) is not
    ported yet and raises."""
    if opt_cfg.accum_steps != 1:
        raise NotImplementedError(
            "accum_steps > 1 (microbatch accumulation) is not ported yet "
            "(ROADMAP.md)")

    def mark(name: str) -> None:
        if marks is not None:
            marks(name)

    def train_step(state: TrainState, *batch) -> tuple[TrainState, dict]:
        named = [(k, p) for k, p in opt_lib.named_leaves(state.params).items()
                 if p.requires_grad]
        loss = loss_fn(state.params, *batch)
        mark("forward")
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        grads = {k: g for (k, _), g in zip(named, grads) if g is not None}
        mark("backward")
        metrics = {"loss": loss.detach(),
                   "grad_norm": opt_lib.global_norm(grads),
                   "lr": opt_lib.schedule_lr(opt_cfg, state.step)}
        params, opt_state, deltas = opt_lib.update_with_deltas(
            grads, state.opt_state, state.params, opt_cfg, state.rng,
            marks=marks)
        if emit_deltas:
            metrics["rotation_deltas"] = deltas
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1, rng=state.rng), metrics)

    return train_step
