"""AdamW or Adafactor with rotation-learner manifold routing (port of
``repro/training/optimizer.py``).

Ordinary parameters get AdamW exactly as the JAX package's ``_update_impl``
(``:200-272``) computes it: the global gradient norm over every leaf, the
rotations' included, clips the gradients before anything else sees them;
the moments are bias-corrected as (μ/b1c)/(√(ν/b2c) + ε); weight decay is
added to the update, not decoupled; the rate follows a cosine schedule with
a linear warm-up. This is not ``torch.optim.AdamW``, which decouples the
decay and places ε elsewhere. A leaf whose name is in ``MANIFOLD_LEAVES``
is an SO(n) rotation and goes to the learner of ``OptimizerConfig.rotation``
instead: GCD-R, GCD-G or GCD-S (Algorithm 2 through the gcd_score and
givens_rotate kernels, a ``GivensDelta``), Cayley-SGD (a linear solve and a
``DenseDelta``) or the frozen control. The routing does not look at the
delta's kind; ``update_with_deltas`` hands it on as the learner made it.

Parameters are a dict of tensors keyed by the JAX path keys (``item_table``,
``index/R``, ...) or an ``nn.Module``, whose ``named_parameters`` give them.
``update`` works in place: the parameters, the moments in the state and the
gradients handed in are overwritten. At the paper's width the item table
and each of its gradient and moments is 3.16 GB, and JAX's fresh copies
would add three more. A leaf without a gradient (one the loss does not
reach, like the index layer during warm-up) gets a zero one, as every leaf
does under ``jax.grad``: its moments decay, weight decay moves it, and a
rotation goes through its learner all the same.

Parameters may also be a nested dict (the transformer's
``layers/attn/wq``), flattened to the same path keys. The update is
computed in ``compute_dtype`` (the gradient cast to it before the clip)
and cast back to the parameter's dtype; the moments are stored in
``moment_dtype`` whatever the parameter's dtype, as in the JAX package.
Where all three are one dtype, the leaf is updated in place without a
copy. The numerical constants are rounded to the compute dtype as the JAX
package's weak-typed arithmetic rounds them. ``global_norm`` accumulates
in float32 for half-precision gradients.

A stacked (L, n, n) rotation (the per-layer KV rotations ``kvq/rot_k``,
``kvq/rot_v``) keeps one learner state stacked on the leading L axis, the
layout of the JAX package's vmapped state, so a checkpoint of either
package reads in the other; the update runs layer by layer through the
learner (and its kernels), a random learner taking its draws for each
layer in turn from the one generator, and ``update_with_deltas`` returns
the layers' deltas stacked on L. The learner state holds R in the leaf's
dtype, as the JAX package's ``init_from(p)`` does; its accumulators stay
float32. A rotation stored in bfloat16 is re-synced into the learner in
float32 each step (the givens_rotate kernel takes float32), moved in
float32, and rounded to bf16 once: that one tensor is the new leaf and
the state's R, so the two stay bit-equal after every step, as in JAX,
where ``materialize`` returns ``state.R`` (ROADMAP.md, parity hazards).
Gradient accumulation
(``accum_steps``, ``accum_dtype``) lives in ``training.train_state``.

``name="adafactor"`` (the JAX package's choice above 50B parameters,
``launch.cells._opt_cfg_for``) is Shazeer and Stern's Adafactor with β1 =
0 as the JAX package's ``_adafactor_leaf`` computes it: the second moment
factored into float32 row and column statistics (``factored_shapes``: a
stacked (L, E, d, f) leaf factors per layer and expert) held in the
``mu`` and ``nu`` slots whatever ``moment_dtype`` says, the decay
1 − t^−0.8, the squares taken in the gradient's own dtype and summed in
float32, the update u = g·rsqrt(v̂) clipped to an RMS of 1 and then
weight-decayed, all in ``compute_dtype``. A manifold leaf's slots pass
through untouched. The update goes over a leaf in blocks of at most
``ADAFACTOR_CHUNK`` elements, the gradient's storage holding u, so a
6.4 GB expert leaf needs no full-size temporaries.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import rotations as rot_lib
from repro_torch.sharding import placed as pl
from repro_torch.sharding import rules as sh

MANIFOLD_LEAVES = ("R", "rot_k", "rot_v")
#: elements of a leaf an Adafactor pass works on at a time
ADAFACTOR_CHUNK = 1 << 27
#: elements of a half-precision gradient widened at a time by global_norm
NORM_CHUNK = 1 << 28
#: the most elements one cuBLAS dot product takes
DOT_MAX = 2**31 - 1


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
    schedule: str = "cosine"         # cosine | constant
    accum_dtype: torch.dtype = torch.float32
    name: str = "adamw"              # adamw | adafactor
    moment_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    mu: dict[str, torch.Tensor]   # first moments (Adafactor: row stats)
    nu: dict[str, torch.Tensor]   # second moments (Adafactor: column stats)
    rot: dict[str, Any]           # path key -> learner state (manifold)
    step: int


def path_key(name: str) -> str:
    """The JAX path key of a parameter name: ``index.R`` -> ``index/R``."""
    return name.replace(".", "/")


def is_manifold(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in MANIFOLD_LEAVES


def named_leaves(params) -> dict[str, torch.Tensor]:
    """Parameters keyed by their JAX path keys (a nested dict's keys
    joined by ``/``); a placed leaf (``sharding.placed.Placed``) is one
    leaf under its own key."""
    if isinstance(params, nn.Module):
        return {path_key(n): p for n, p in pl.module_leaves(params)}
    out: dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: str) -> None:
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key] = v

    walk(params, "")
    return out


def _check_name(cfg: OptimizerConfig) -> None:
    if cfg.name not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")


def factored_shapes(shape) -> tuple[tuple, tuple]:
    """Adafactor's factored second-moment shapes (row stat, column stat):
    for ndim ≥ 2 the row stat drops the last axis and the column stat the
    second-to-last; a 1-D or 0-D leaf keeps a full-size stat in the row
    slot and a scalar in the column slot."""
    shape = tuple(shape)
    if len(shape) >= 2:
        return shape[:-1], shape[:-2] + shape[-1:]
    return shape, ()


def stack_states(states: list):
    """One learner state from per-layer states, every field stacked on a
    new leading axis (the layout of a vmapped JAX state)."""
    return type(states[0])(*(torch.stack(f) for f in zip(*states)))


def layer_state(state, i: int):
    """Layer i's learner state out of a stacked one."""
    return type(state)(*(f[i] for f in state))


def _stack_deltas(deltas: list):
    first = deltas[0]
    if isinstance(first, rot_lib.DenseDelta):
        return rot_lib.DenseDelta(dR=torch.stack([d.dR for d in deltas]))
    return rot_lib.GivensDelta(
        pi=torch.stack([d.pi for d in deltas]),
        pj=torch.stack([d.pj for d in deltas]),
        theta=torch.stack([d.theta for d in deltas]),
        overlapping=first.overlapping)


def _init_rot_leaf(learner, p: torch.Tensor):
    """The learner state of one manifold leaf, R in the leaf's dtype,
    stacked for (L, n, n)."""
    R = p.detach().clone()
    if R.dim() == 3:
        return stack_states([learner.init_from(r) for r in R])
    return learner.init_from(R)


def init(params, cfg: OptimizerConfig) -> OptState:
    _check_name(cfg)
    leaves = named_leaves(params)
    learner = rot_lib.from_config(cfg.rotation)

    def zeros(p, slot: int):
        if pl.is_placed(p):
            return _placed_moment(p, slot, cfg)
        if cfg.name == "adafactor":    # float32 factored stats
            return torch.zeros(factored_shapes(p.shape)[slot],
                               dtype=torch.float32, device=p.device)
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return OptState(
        mu={k: zeros(p, 0) for k, p in leaves.items()},
        nu={k: zeros(p, 1) for k, p in leaves.items()},
        rot={k: _init_rot_leaf(learner, p)
             for k, p in leaves.items() if is_manifold(k)},
        step=0)


def _f32(x) -> np.float32:
    return np.float32(x)


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """Linear warm-up, then a cosine decay (``schedule="cosine"``) or a
    constant rate (``"constant"``), in float32 as the JAX package computes
    it."""
    s = _f32(step)
    warm = min(_f32(1.0), (s + _f32(1.0)) / _f32(max(cfg.warmup_steps, 1)))
    if cfg.schedule == "cosine":
        frac = np.clip(s / _f32(max(cfg.total_steps, 1)), _f32(0.0),
                       _f32(1.0))
        decay = _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * frac))
    else:
        decay = _f32(1.0)
    return float(_f32(cfg.lr) * warm * decay)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ over leaves of ⟨g, g⟩), float32, on the first gradient's
    device; one dot product per leaf, so no squared copy of the table is
    made. A half-precision leaf is widened to float32 first, NORM_CHUNK
    elements at a time, so its sum accumulates in float32 (as the JAX
    package's ``preferred_element_type``), not in the leaf's dtype; so is
    a leaf of more than 2³¹ − 1 elements (two-tower-retrieval's 10M × 256
    table), which cuBLAS's dot cannot take in one call. A placed leaf
    contributes each piece's dot, taken on that piece's device; the
    partials are added on the first device in shard order (the JAX
    package's sharded norm is a psum of per-device partials too)."""
    total = None
    for leaf in grads.values():
        for g in pl.pieces_of(leaf):
            g = g.reshape(-1)
            half = g.dtype in (torch.bfloat16, torch.float16)
            whole = not half and g.numel() <= DOT_MAX
            for c in (g,) if whole else g.split(NORM_CHUNK):
                if half:
                    c = c.float()          # one chunk's copy at a time
                sq = torch.dot(c, c)
                if total is None:
                    total = sq
                else:
                    total = total + (sq if sq.device == total.device
                                     else sq.to(total.device))
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _cst(x, dtype: torch.dtype) -> float:
    """A constant rounded to ``dtype``, as the JAX package's
    ``jnp.asarray(x, dtype)`` and weak-typed arithmetic round it."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def _adamw_leaf(cfg, p, g, mu, nu, lr: float, b1c: float, b2c: float):
    """One AdamW leaf; ``g`` is the clipped gradient in the compute dtype
    (consumed). The moments are updated in the compute dtype and stored
    in theirs, the parameter likewise; where the dtypes agree, in place."""
    cdt = cfg.compute_dtype
    b1, b2 = _cst(cfg.beta1, cdt), _cst(cfg.beta2, cdt)
    m = mu if mu.dtype == cdt else mu.to(cdt)
    v = nu if nu.dtype == cdt else nu.to(cdt)
    m.mul_(b1).add_(g * _cst(1.0 - b1, cdt))
    tmp = g * g
    v.mul_(b2).add_(tmp.mul_(_cst(1.0 - b2, cdt)))
    torch.div(v, _cst(b2c, cdt), out=tmp).sqrt_().add_(_cst(cfg.eps, cdt))
    upd = torch.div(m, _cst(b1c, cdt), out=g).div_(tmp)
    if m is not mu:
        mu.copy_(m)
        nu.copy_(v)
    if cfg.weight_decay > 0:
        upd.add_(p.to(cdt) * _cst(cfg.weight_decay, cdt))
    upd.mul_(_cst(lr, cdt))
    if p.dtype == cdt:
        p.sub_(upd)
    else:
        p.copy_(p.to(cdt).sub_(upd))


def _blocks(shape: tuple, chunk: int) -> list:
    """Index tuples that cover an (N, rows, cols) view in blocks of at
    most ``chunk`` elements (whole slices when they fit, else row
    ranges of one slice)."""
    N, rows, cols = shape
    if rows * cols <= chunk:
        per = max(1, chunk // (rows * cols))
        return [(slice(n, min(n + per, N)),) for n in range(0, N, per)]
    step = max(1, chunk // cols)
    return [(n, slice(r, min(r + step, rows)))
            for n in range(N) for r in range(0, rows, step)]


def _adafactor_leaf(cfg, p, g, vr, vc, lr: float, t: np.float32):
    """One Adafactor leaf (the JAX package's ``_adafactor_leaf``): ``g``,
    the clipped gradient in the compute dtype, is consumed (it holds u);
    p, vr and vc are written in place."""
    cdt = cfg.compute_dtype
    eps = 1e-30
    b2 = _f32(1.0) - t ** _f32(-0.8)
    keep, new = float(b2), float(_f32(1.0) - b2)
    if p.dim() >= 2:
        shape = (math.prod(p.shape[:-2]), p.shape[-2], p.shape[-1])
        G, P = g.contiguous().view(shape), p.view(shape)
        VR, VC = vr.view(shape[:2]), vc.view(shape[0], shape[2])
        blocks = _blocks(shape, ADAFACTOR_CHUNK)
        r = torch.empty(VR.shape, dtype=torch.float32, device=p.device)
        c = torch.zeros(VC.shape, dtype=torch.float32, device=p.device)
        for b in blocks:
            g2 = G[b] * G[b]              # squared in the gradient's dtype
            r[b] = torch.sum(g2, dim=-1, dtype=torch.float32) / shape[2]
            c[b[0]] += torch.sum(g2, dim=-2, dtype=torch.float32)
        VR.mul_(keep).add_(r.mul_(new))
        VC.mul_(keep).add_(c.div_(shape[1]).mul_(new))
        denom = torch.clamp(VR.mean(-1, keepdim=True), min=eps)
        rfac = torch.rsqrt(VR / denom + eps)
        cfac = torch.rsqrt(VC + eps)
        for b in blocks:
            fac = rfac[b][..., None] * cfac[b[0]][..., None, :]
            G[b].mul_(fac.to(cdt))
    else:
        G, P = g, p
        vr.mul_(keep).add_(g.float().square().mul_(new))
        G.mul_(torch.rsqrt(vr + eps).to(cdt))
        blocks = [()]
    sq = None
    for b in blocks:
        u = G[b].float().reshape(-1)
        d = torch.dot(u, u)
        sq = d if sq is None else sq + d
    rms = torch.sqrt(torch.clamp(sq * (1.0 / float(g.numel())), min=1e-30))
    scale = (lr / torch.clamp(rms, min=1.0)).to(cdt)
    wd = _cst(cfg.weight_decay, cdt)
    for b in blocks:
        u = G[b]
        if cfg.weight_decay > 0:
            u.add_(P[b].to(cdt) * wd)
        u.mul_(scale)
        if P.dtype == cdt:
            P[b].sub_(u)
        else:
            P[b].copy_(P[b].to(cdt).sub_(u))


def _placed_moment(p, slot: int, cfg: OptimizerConfig):
    """A placed leaf's zero moment in ``slot`` (0: mu, 1: nu). AdamW's is
    placed as the leaf; Adafactor's factored stat takes the spec's
    entries of its remaining dimensions (the JAX package's
    ``opt_shardings``), placed where those split something and whole on
    the mesh's first device otherwise."""
    if cfg.name != "adafactor":
        return p.like([torch.zeros(q.shape, dtype=cfg.moment_dtype,
                                   device=q.device) for q in p.pieces])
    shape = factored_shapes(p.shape)[slot]
    spec = tuple(p.sharding.spec) + (None,) * (p.dim() - len(p.sharding.spec))
    if p.dim() >= 2:
        spec = spec[:-1] if slot == 0 else spec[:-2] + spec[-1:]
    elif slot == 1:
        spec = ()
    stat = sh.NamedSharding(p.sharding.mesh, sh.P(*spec))
    z = torch.zeros(shape, dtype=torch.float32,
                    device=p.sharding.mesh.devices[0])
    return z if stat.splits_nothing else pl.place(z, stat,
                                                  requires_grad=False)


def _shard_sum(parts: list, dev: torch.device) -> torch.Tensor:
    """Partials added on ``dev`` in shard order."""
    total = None
    for x in parts:
        x = x if x.device == dev else x.to(dev)
        total = x if total is None else total + x
    return total


def _adafactor_placed(cfg, p, gs: list, vr, vc, lr: float, t: np.float32):
    """``_adafactor_leaf`` on a placed leaf, piece by piece: ``gs`` are
    the pieces' clipped gradients in the compute dtype (consumed). The
    factored statistics are the whole leaf's: a sum over a split
    dimension (the column stat of a row-split 2-D table, the row
    stats' mean) adds the pieces' partials in shard order on the mesh's
    first device, as does the update's RMS. Splits of the last two
    dimensions of a leaf of 3 or more dimensions, or of a 2-D leaf's
    columns, raise."""
    cdt = cfg.compute_dtype
    eps = 1e-30
    b2 = _f32(1.0) - t ** _f32(-0.8)
    keep, new = float(b2), float(_f32(1.0) - b2)
    split = p.sharding.splits(p.dim())
    head = p.sharding.mesh.devices[0]
    rows_split = p.dim() == 2 and split[0] > 1
    if (p.dim() >= 3 and any(n > 1 for n in split[-2:])) or (
            p.dim() == 2 and split[1] > 1):
        raise NotImplementedError(
            f"Adafactor on a leaf of {tuple(p.shape)} split {split}: only "
            "leading dimensions (a 2-D table's rows) split (ROADMAP.md "
            "queue 1, item 11b)")
    P = p.pieces
    VR = pl.pieces_of(vr)
    if p.dim() >= 2:
        rows, cols = p.shape[-2], p.shape[-1]
        G3 = [g.view(-1, g.shape[-2], g.shape[-1]) for g in gs]
        g2s = [g * g for g in G3]           # squared in the gradient's dtype
        r = [torch.sum(x, dim=-1, dtype=torch.float32) / cols for x in g2s]
        c = [torch.sum(x, dim=-2, dtype=torch.float32) for x in g2s]
        del g2s
        if rows_split:
            c = [_shard_sum(c, head)]
            VCs = [vc.view(1, cols)]
            vrs = [v.view(1, -1) for v in VR]
        else:
            VCs = [v.view(-1, cols) for v in pl.pieces_of(vc)]
            vrs = [v.view(-1, v.shape[-1]) for v in VR]
        for v, x in zip(vrs, r):
            v.mul_(keep).add_(x.mul_(new))
        for v, x in zip(VCs, c):
            v.mul_(keep).add_(x.div_(rows).mul_(new))
        if rows_split:
            mean = _shard_sum([v.sum(dim=-1, keepdim=True) for v in vrs],
                              head) / float(p.shape[0])
            denoms = [torch.clamp(mean, min=eps).to(v.device) for v in vrs]
            VCs = [VCs[0].to(v.device) for v in vrs]
        else:
            denoms = [torch.clamp(v.mean(-1, keepdim=True), min=eps)
                      for v in vrs]
        for g, v, d, vcol in zip(G3, vrs, denoms, VCs):
            fac = torch.rsqrt(v / d + eps)[..., None] * torch.rsqrt(
                vcol + eps)[..., None, :]
            g.mul_(fac.to(cdt))
    else:
        for g, v in zip(gs, VR):
            v.mul_(keep).add_(g.float().square().mul_(new))
            g.mul_(torch.rsqrt(v + eps).to(cdt))
    sq = _shard_sum([torch.dot(g.float().reshape(-1), g.float().reshape(-1))
                     for g in gs], head)
    rms = torch.sqrt(torch.clamp(sq * (1.0 / float(p.numel())), min=1e-30))
    scale = (lr / torch.clamp(rms, min=1.0)).to(cdt)
    wd = _cst(cfg.weight_decay, cdt)
    for q, u in zip(P, gs):
        if cfg.weight_decay > 0:
            u.add_(q.to(cdt) * wd)
        u.mul_(scale.to(u.device))
        if q.dtype == cdt:
            q.sub_(u)
        else:
            q.copy_(q.to(cdt).sub_(u))


def _rotate_into(learner, p: torch.Tensor, st, g, lr: float, generator):
    """One learner step of the rotation ``p`` (written in place): the state
    re-synced from p in float32, moved in float32, and the moved R rounded
    once to p's dtype, which becomes both p and the state's R."""
    st, delta = learner.update(learner.with_rotation(st, p.detach().float()),
                               g, lr, generator)
    R = learner.materialize(st).to(p.dtype)
    p.copy_(R)
    return learner.with_rotation(st, R), delta


def _rotation_leaf(learner, cfg, p, g, st, generator):
    """One manifold leaf: (new learner state, delta), p written in place.
    A stacked (L, n, n) leaf goes layer by layer and comes back stacked."""
    lr = cfg.rotation.lr
    if p.dim() == 3:
        states, deltas = [], []
        for i in range(p.shape[0]):
            s_i, d_i = _rotate_into(learner, p[i], layer_state(st, i), g[i],
                                    lr, generator)
            states.append(s_i)
            deltas.append(d_i)
        return stack_states(states), _stack_deltas(deltas)
    return _rotate_into(learner, p, st, g, lr, generator)


def _update_impl(grads, state: OptState, params, cfg: OptimizerConfig,
                 generator: torch.Generator | None = None,
                 marks: Callable[[str], None] | None = None):
    _check_name(cfg)
    leaves = named_leaves(params)
    step = state.step
    lr = schedule_lr(cfg, step)
    t = _f32(step + 1)
    b1c = float(_f32(1.0) - _f32(cfg.beta1) ** t)
    b2c = float(_f32(1.0) - _f32(cfg.beta2) ** t)
    cdt = cfg.compute_dtype
    learner = rot_lib.from_config(cfg.rotation)
    rot_n = dict(state.rot)
    deltas: dict[str, Any] = {}
    with torch.no_grad():
        grads = {k: grads[k] if k in grads
                 else pl.map_pieces(torch.zeros_like, p)
                 for k, p in leaves.items()}
        clip = None
        if cfg.grad_clip > 0:
            clip = torch.clamp(
                cfg.grad_clip / torch.clamp(global_norm(grads), min=1e-9),
                max=1.0).to(cdt)

        def clipped(g):
            g = g.to(cdt)
            if clip is None:
                return g
            return g.mul_(clip if clip.device == g.device
                          else clip.to(g.device))

        for k in grads:
            if is_manifold(k):
                continue
            p, g, mu, nu = leaves[k], grads[k], state.mu[k], state.nu[k]
            if cfg.name == "adafactor" and pl.is_placed(p):
                _adafactor_placed(cfg, p, [clipped(x) for x in g.pieces],
                                  mu, nu, lr, t)
            elif cfg.name == "adafactor":
                _adafactor_leaf(cfg, p, clipped(g), mu, nu, lr, t)
            else:                      # a placed leaf piece by piece
                for pp, gp, mp, vp in zip(*map(pl.pieces_of,
                                               (p, g, mu, nu))):
                    _adamw_leaf(cfg, pp, clipped(gp), mp, vp, lr, b1c, b2c)
        if marks is not None:
            marks(cfg.name)
        for k in grads:
            if is_manifold(k):
                rot_n[k], deltas[k] = _rotation_leaf(
                    learner, cfg, leaves[k], clipped(grads[k]),
                    state.rot[k], generator)
        if marks is not None:
            marks("rotation")
    return params, OptState(mu=state.mu, nu=state.nu, rot=rot_n,
                            step=step + 1), deltas


def update(grads: dict[str, torch.Tensor], state: OptState, params,
           cfg: OptimizerConfig, generator: torch.Generator | None = None,
           marks: Callable[[str], None] | None = None):
    """(params, state) after one step: clip the global gradient norm (when
    ``grad_clip`` > 0), then AdamW or Adafactor on every leaf but the SO(n)
    ones, which go through the configured rotation learner. In place (see
    the module docstring). ``marks``, if given, is called with the
    optimizer's name ("adamw" or "adafactor") and "rotation" after each
    part."""
    p_n, state_n, _deltas = _update_impl(grads, state, params, cfg,
                                         generator, marks)
    return p_n, state_n


def update_with_deltas(grads: dict[str, torch.Tensor], state: OptState,
                       params, cfg: OptimizerConfig,
                       generator: torch.Generator | None = None,
                       marks: Callable[[str], None] | None = None):
    """``update`` that also returns ``{path key: RotationDelta}`` for the
    manifold leaves, for a live index to absorb (a stacked leaf's deltas
    stacked on its leading layer axis)."""
    return _update_impl(grads, state, params, cfg, generator, marks)
