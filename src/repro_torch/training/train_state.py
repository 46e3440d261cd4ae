"""Train state and the train-step builder (port of
``repro/training/train_state.py``).

``make_train_step(loss_fn, opt_cfg)`` turns ``loss_fn(params, *batch)`` into
a ``(state, *batch) -> (state, metrics)`` step that differentiates the loss
(the rotation ``R`` included: its gradient feeds the rotation learner) and
applies ``training.optimizer`` (AdamW or Adafactor, plus the manifold
learner). PyTorch runs eagerly, so there is nothing to jit; the step
updates the parameters in place (see ``training.optimizer``).

``eq1_loss`` is the paper's Eq. (1) for any quantizer with ``encode_st``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding import placed as pl
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
                    grad_shardings=None,
                    emit_deltas: bool = False,
                    marks: Callable[[str], None] | None = None) -> Callable:
    """loss_fn(params, *batch) -> scalar. Returns the step function.

    A placed leaf (``sharding.placed.Placed``) is differentiated piece by
    piece: its gradient is a ``Placed`` of the same sharding, each piece
    on its piece's device. ``grad_shardings`` is the JAX argument that
    pins each gradient to its parameter's sharding; the port's gradients
    live on their pieces already, so it is accepted and not read.

    ``emit_deltas=True`` adds ``metrics["rotation_deltas"]``, the
    ``{path key: RotationDelta}`` each manifold update applied. ``marks``,
    if given, is called with "forward", "backward", the optimizer's name
    ("adamw" or "adafactor") and "rotation" as each part of the step has
    been enqueued (``chip_smoke.py`` records a CUDA event there).

    ``opt_cfg.accum_steps = A > 1`` splits every batch tensor into A
    microbatches along axis 0 (which A must divide), folds 1/A into each
    microbatch's loss and sums the gradients in ``opt_cfg.accum_dtype``.
    Each microbatch's graph is differentiated and dropped before the next
    is built, so only one microbatch's activations are alive at a time.
    The step's loss is the sum of the scaled losses; "forward" and
    "backward" are both marked after the last microbatch."""
    A = int(opt_cfg.accum_steps)
    if A < 1:
        raise ValueError(f"accum_steps must be >= 1, got {A}")

    def mark(name: str) -> None:
        if marks is not None:
            marks(name)

    def _grads(params, named, batch):
        leaves = [q for _, p in named for q in pl.pieces_of(p)]

        def regroup(grads) -> dict:
            """{key: gradient}, a placed leaf's pieces as one ``Placed``
            (a piece the loss does not reach gets zeros)."""
            out, i = {}, 0
            for k, p in named:
                ps = pl.pieces_of(p)
                gs = list(grads[i:i + len(ps)])
                i += len(ps)
                if all(g is None for g in gs):
                    continue
                if pl.is_placed(p):
                    out[k] = p.like([torch.zeros_like(q) if g is None else g
                                     for q, g in zip(ps, gs)])
                else:
                    out[k] = gs[0]
            return out

        if A == 1:
            loss = loss_fn(params, *batch)
            mark("forward")
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), regroup(grads)
        micro = [_split(x, A) for x in batch]
        inv = 1.0 / A
        lsum, gsum = None, {}

        def acc(a, g):
            return g if a is None else a + g

        for i in range(A):
            loss = loss_fn(params, *[m[i] if m is not None else x
                                     for m, x in zip(micro, batch)]) * inv
            grads = regroup(torch.autograd.grad(loss, leaves,
                                                allow_unused=True))
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
            for k, g in grads.items():
                g = pl.map_pieces(lambda x: x.to(opt_cfg.accum_dtype), g)
                gsum[k] = g if k not in gsum else pl.map_pieces(
                    acc, gsum[k], g)
            del loss, grads
        mark("forward")
        return lsum, gsum

    def train_step(state: TrainState, *batch) -> tuple[TrainState, dict]:
        named = [(k, p) for k, p in opt_lib.named_leaves(state.params).items()
                 if p.requires_grad]
        loss, grads = _grads(state.params, named, batch)
        mark("backward")
        metrics = {"loss": loss,
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


def _split(x, A: int):
    """A tensor batch argument as A microbatches along axis 0 (a view), or
    None for an argument that is not split (a scalar or a non-tensor)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return None
    if x.shape[0] % A:
        raise ValueError(f"accum_steps={A} does not divide the batch axis "
                         f"of a {tuple(x.shape)} argument")
    return x.reshape(A, x.shape[0] // A, *x.shape[1:])
