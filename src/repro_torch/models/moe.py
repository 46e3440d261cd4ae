"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro/models/moe.py``).

The dispatch is the JAX package's, step for step:

  1. top-k routing in float32 → a (token, expert) list of length T·k
  2. a stable argsort by expert id → expert-contiguous order
  3. each entry's position within its expert from the exclusive prefix of
     the per-expert counts; entries beyond the capacity C drop (the token
     keeps its residual path)
  4. a gather into a dense (E, C, d) buffer → batched expert GEMMs
  5. a gather back by (expert, position), the unsort, the gate weights and
     the sum over the k choices.

No (T, E, C) tensor is made; memory is O(T·k·d + E·C·d). Every step is a
gather, so autograd's backward is an ``index_put_`` with accumulation,
whose order of additions on the card is not fixed: training that must
give one answer a seed runs under ``torch.use_deterministic_algorithms``.

The router's top-k takes the largest probabilities with ties to the lowest
expert id, as ``jax.lax.top_k`` does: a stable descending sort, not
``torch.topk``, whose tie order differs (ROADMAP.md, parity hazards).
There is no Pallas kernel on this path in the JAX package; the expert
products are ``torch.bmm``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

#: A profiling hook: called with the name of each part of a block as it is
#: enqueued ("route", "dispatch", "experts", "combine").
Marks = Callable[[str], None] | None


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: T·k·factor / E rounded up to 8, at least 8."""
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """(probs (T, E), gates (T, k), ids (T, k)), all in float32 but the
    int64 ids: softmax of x·W, the top k with ties to the lowest id, the
    gates renormalised over the k choices."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = top[:, :cfg.top_k], order[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def expert_counts(sorted_ids: torch.Tensor, num_experts: int):
    """(counts, exclusive starts) per expert of an ascending id list; a
    search, not an atomic histogram, so it is deterministic on the card."""
    experts = torch.arange(num_experts, device=sorted_ids.device)
    starts = torch.searchsorted(sorted_ids, experts)
    ends = torch.searchsorted(sorted_ids, experts, right=True)
    return ends - starts, starts


def _mark(marks: Marks, name: str) -> None:
    if marks is not None:
        marks(name)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor | None, wo: torch.Tensor, cfg: MoEConfig, *,
              activation: str, marks: Marks = None):
    """x (T, d), router_w (d, E), wi/wg (E, d, f), wo (E, f, d) → (output
    (T, d) in x's dtype, the float32 load-balance loss). ``marks``, if
    given, is called after each part ("route": the router, its top-k, the
    aux loss and the sort; "dispatch": the gather into (E, C, d);
    "experts": the GEMMs; "combine")."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(T, cfg)
    dev = x.device

    probs, gates, ids = route(x, router_w, cfg)
    # Switch-style auxiliary load-balance loss
    density = F.one_hot(ids[:, 0], E).float().mean(0)
    aux = (density * probs.mean(0)).sum() * E

    flat_ids = ids.reshape(-1)                                  # (T·k,)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    inv = torch.argsort(order)                      # the unsort permutation
    s_ids = flat_ids[order]
    s_tok = flat_tok[order]
    counts, starts = expert_counts(s_ids, E)
    _mark(marks, "route")

    # dispatch: slot[e, c] = the sorted position of expert e's c-th token
    cap = torch.arange(C, device=dev)
    slot = starts[:, None] + cap[None, :]                       # (E, C)
    valid = cap[None, :] < counts[:, None]
    tok_idx = s_tok[slot.clamp(0, T * k - 1)]
    xe = x[tok_idx] * valid[..., None].to(x.dtype)              # (E, C, d)
    _mark(marks, "dispatch")

    h = torch.bmm(xe, wi.to(xe.dtype))
    if wg is not None:
        h = layers.activate(h, activation) * torch.bmm(xe, wg.to(xe.dtype))
    else:
        h = layers.activate(h, activation)
    ye = torch.bmm(h, wo.to(h.dtype))                           # (E, C, d)
    _mark(marks, "experts")

    # combine: gather back by (expert, position), unsort, weight, sum
    pos = torch.arange(T * k, device=dev) - starts[s_ids]
    keep = pos < C
    val = ye[s_ids, pos.clamp(0, C - 1)] * keep[:, None].to(ye.dtype)
    y_tk = val[inv].reshape(T, k, d) * gates[..., None].to(val.dtype)
    out = y_tk.sum(1).to(x.dtype)
    _mark(marks, "combine")
    return out, aux


def dropped(ids: torch.Tensor, cfg: MoEConfig,
            num_tokens: int) -> torch.Tensor:
    """How many of the T·k (token, expert) entries of ``ids`` overflow
    their expert's capacity: a 0-d tensor on ids' device (no host read)."""
    counts, _ = expert_counts(torch.sort(ids.reshape(-1)).values,
                              cfg.num_experts)
    return torch.clamp(counts - capacity(num_tokens, cfg), min=0).sum()
