"""The optimizer choice of ``repro/launch/cells.py`` (``_opt_cfg_for``,
``:159-178``) for the port.

The rest of the JAX file lowers each (architecture × shape × mesh) cell on
fake XLA devices for a dry run; its port waits for a design of a per-cell
memory and FLOP estimate on one H100 (ROADMAP.md queue 1, item 13).
"""
from __future__ import annotations

import torch

from repro_torch import rotations
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib

#: parameters above which an architecture trains with Adafactor in bf16
BIG_PARAMS = 50e9


def _opt_cfg_for(cfg) -> opt_lib.OptimizerConfig:
    """Over 50B parameters: Adafactor (a factored second moment, no first:
    AdamW's two parameter-sized moments do not fit), no global gradient
    clip (Adafactor's update-RMS clip takes its place), bf16 moment,
    compute and accumulation dtypes; AdamW in float32 with a clip of 1
    otherwise. lr 3e-4, GCD-G at lr 1e-3 on the rotations, and the
    config's own microbatch accumulation."""
    big, accum = False, 1
    if isinstance(cfg, tfm.TransformerConfig):
        big = tfm.num_params(cfg) > BIG_PARAMS
        accum = cfg.train_accum_steps
    half = torch.bfloat16 if big else torch.float32
    return opt_lib.OptimizerConfig(
        name="adafactor" if big else "adamw",
        grad_clip=0.0 if big else 1.0,
        lr=3e-4, moment_dtype=half, compute_dtype=half,
        accum_steps=accum, accum_dtype=half,
        rotation=rotations.RotationConfig(learner="gcd", method="greedy",
                                          lr=1e-3),
    )
