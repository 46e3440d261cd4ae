"""Error-feedback int8 gradient compression for the cross-pod all-reduce
(port of ``repro/training/grad_compress.py``) over ``torch.distributed``.

The slowest hop of a multi-pod run is the one between pods, so its
all-reduce carries int8 in place of float32: one shared scale (a
one-element max-reduce first), each participant's payload pre-divided by
the group's size so that the integer sum stays in int8's range, and the
quantization residual kept for the next step (error feedback):

    x      = g + err                      (apply feedback)
    q      = round(x / (s·n)) ∈ [−127, 127/n]
    g_out  = Σ q · s · n
    err'   = x − q·s·n                    (carry what was lost)

The arithmetic is the JAX package's, operation for operation, so the two
give the same bits on the CPU: ``torch.round`` rounds half to even as
``jnp.round`` does, and the divisions are true divisions (the 127 is a
tensor on x's device: CUDA multiplies by the reciprocal of a host scalar
divisor).

Reference caveat (ROADMAP.md, "Reference caveats"): the pre-division does
not keep the sum in range. The participant that holds the largest |x| has
x / (s·n) = 127 / n there; at n = 2 that is 63.5, which rounds half to
even to 64, and two participants with the same positive gradient sum to
128 there, which wraps to −128 in int8. The JAX ``psum`` of int8 wraps so,
and the port sums int8 on the wire as JAX does, so it wraps alike: two
equal gradients whose largest entry is a > 0 sum to −128·(a/127)·2 ≈
−2.016·a there, in place of 2a. The port reproduces the reference and
does not widen the sum.

The process group is the caller's (``make_compressed_crosspod_psum(group)``
stands for the JAX ``(mesh, "pod")``): one rank per pod, each passing its
own gradient and its own error buffer, each getting back the replicated
sum and its own error. On NCCL the payload stays on the card. The gloo
backend is a host transport: for a CUDA tensor it copies the payload to
host memory and back inside the collective (``ProcessGroupGloo``), which
is what two ranks on one card use (NCCL cannot put two ranks on one GPU);
the quantization, the dequantization and the error stay on the tensors'
device either way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in float32, by a true division."""
    return torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)


def _quantize(xf: torch.Tensor, scale: torch.Tensor,
              axis_size: int) -> torch.Tensor:
    return torch.clamp(torch.round(xf / (scale * axis_size)),
                       -127, 127).to(torch.int8)


def ef_quantize(x: torch.Tensor, err: torch.Tensor, axis_size: int):
    """(q int8, scale float32 scalar, new_err): shared-scale int8 with
    1/axis_size headroom, the JAX ``ef_quantize``."""
    xf = x.float() + err
    scale = _scale(torch.max(torch.abs(xf)))
    q = _quantize(xf, scale, axis_size)
    deq = q.float() * scale * axis_size
    return q, scale, xf - deq


def ef_psum_int8(g: torch.Tensor, err: torch.Tensor, group, axis_size: int):
    """All-reduce ``g`` over ``group`` with an int8 payload, the JAX
    ``ef_psum_int8``: the largest |g + err| max-reduced over the group
    (one element), then the int8 codes summed in int8 (one byte an
    element on the wire; it wraps as JAX's does, see the module
    docstring). Returns (g_summed float32, new_err)."""
    xf = g.float() + err
    amax = torch.max(torch.abs(xf)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(amax.reshape(()))
    q = _quantize(xf, scale, axis_size)
    summed = q.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    g_out = summed.float() * scale * axis_size
    new_err = xf - q.float() * scale * axis_size
    return g_out, new_err


def make_compressed_crosspod_psum(group=None):
    """The reducer f(g, err) -> (g_sum, err') over ``group`` (the default
    group when None), counterpart of the JAX shard_map'd one: each rank
    passes its own gradient and error buffer (the JAX ``P(axis)`` slice of
    one pod, without its leading axis of 1) and gets back the sum over
    the group, replicated, and its own new error."""
    n = dist.get_world_size(group)

    def f(g: torch.Tensor, err: torch.Tensor):
        return ef_psum_int8(g, err, group, n)

    return f
