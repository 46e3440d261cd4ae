"""The paper's two-tower model and its training step, in plain PyTorch.

Model (paper §3.2, Eq. 1): the user tower is the mean of the history's
item embeddings (ids < 0 are padding, the count at least 1) and an MLP;
the item tower is the item's embedding and an MLP; ReLU between layers,
none after the last. The item tower ends in the index layer
T(v) = φ(vR)Rᵀ: φ snaps each subspace of vR to its nearest codeword
(argmin ‖c‖² − 2⟨x, c⟩, ties to the lower codeword), bridged by the
straight-through estimator, and the loss adds the distortion
(1/B)‖vR − φ(vR)‖² (codebooks trained by it, the codes held fixed). Both
towers are L2-normalised (norm clamped at 1e-6), scored against every item
of the batch, and the in-batch hinge Σ_{i≠j} max(0, m + s_ij − s_ii) is
divided by B(B − 1). The scores are formed ROWS rows at a time.

Step: the global gradient norm over every leaf, R's included, clips the
gradients to ``grad_clip``; every leaf but R takes an Adam step with the
moments bias-corrected as (m/(1 − β1ᵗ))/(√(v/(1 − β2ᵗ)) + ε) and no
weight decay, at a constant rate; R takes one Givens coordinate descent
step (paper Algorithm 2): A = GᵀR − RᵀG, n/2 disjoint pairs (GCD-G: the
greedy matching over |A| by decreasing weight, ties to the lower flat
index; GCD-R: the halves of a ``torch.randperm`` drawn from the step's
generator), θ = −λ·A_ij/√2, and columns i, j of R mixed as
(c·r_i + s·r_j, c·r_j − s·r_i).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.ivf_pq import pq_codes
from perfbench.reference.precision import matmul

MANIFOLD = "index/R"
#: rows of the (B, B) score matrix held at a time: each block is recomputed
#: in the backward, so the reference never holds the whole matrix
ROWS = 8192


def leaf_names(num_layers: int) -> list[str]:
    """The leaves in the program's order of keys."""
    mlp = [f"{t}{i}_{w}" for t in ("user", "item") for i in range(num_layers)
           for w in ("w", "b")]
    return ["item_table", *mlp, MANIFOLD, "index/codebooks"]


def _mlp(p, x, prefix: str, layers: int, mm):
    for i in range(layers):
        x = mm(x, p[f"{prefix}{i}_w"]) + p[f"{prefix}{i}_b"]
        if i < layers - 1:
            x = torch.relu(x)
    return x


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def loss(p: dict, hist: torch.Tensor, pos: torch.Tensor, model: dict,
         precision: str = "float32") -> torch.Tensor:
    """The loss of one batch: hist (B, L) −1 padded, pos (B,)."""
    mm = matmul(precision)
    layers = len(model["tower_dims"])
    valid = hist >= 0
    rows = p["item_table"][hist.clamp(min=0)] * valid[..., None]
    cnt = valid.sum(1).clamp(min=1)[:, None].to(rows.dtype)
    u = _mlp(p, rows.sum(1) / cnt, "user", layers, mm)
    v = _mlp(p, p["item_table"][pos], "item", layers, mm)
    R, cb = p[MANIFOLD], p["index/codebooks"]
    D, _, sub = cb.shape
    xr = mm(v, R)
    codes = pq_codes(xr.detach(), cb.detach(), mm)
    d = torch.arange(D, device=v.device)
    q = cb[d, codes].reshape(v.shape[0], D * sub)
    out = mm(xr + (q.detach() - xr.detach()), R.T)
    dist = torch.mean(torch.sum(torch.square(xr - q), dim=-1))
    un, vn = _normalize(u), _normalize(out)
    B = un.shape[0]
    hinge = sum(checkpoint(_hinge_rows, un[r:r + ROWS], vn, r,
                           model["hinge_margin"], mm, use_reentrant=False)
                for r in range(0, B, ROWS))
    return hinge / (float(B) * (B - 1.0)) + model["distortion_weight"] * dist


def _hinge_rows(un, vn, start: int, margin: float, mm):
    """Σ_j≠i max(0, m + s_ij − s_ii) over rows start … start + len(un)."""
    s = mm(un, vn.T)
    i = torch.arange(un.shape[0], device=un.device)
    h = torch.clamp(margin + s - s[i, start + i][:, None], min=0.0)
    h[i, start + i] = 0.0
    return torch.sum(h)


def greedy_pairs(A: np.ndarray) -> tuple[list, list]:
    """GCD-G's matching: i < j edges by decreasing |A_ij| (ties to the lower
    flat index), each taken when both ends are free."""
    n = A.shape[0]
    w = np.where(np.triu(np.ones((n, n), bool), 1), np.abs(A), -np.inf)
    used = np.zeros(n, bool)
    pi, pj = [], []
    for e in np.argsort(-w.ravel(), kind="stable").tolist():
        i, j = divmod(e, n)
        if not used[i] and not used[j]:
            used[i] = used[j] = True
            pi.append(i)
            pj.append(j)
            if len(pi) == n // 2:
                break
    return pi, pj


def gcd_step(R: torch.Tensor, G: torch.Tensor, lr: float, method: str,
             generator: torch.Generator, mm) -> torch.Tensor:
    """R after one Givens coordinate descent step on the gradient G."""
    M = mm(G.T, R)
    A = M - M.T
    n = R.shape[0]
    if method == "greedy":
        pi, pj = (torch.tensor(x, dtype=torch.int64, device=R.device)
                  for x in greedy_pairs(A.cpu().numpy()))
    elif method == "random":
        perm = torch.randperm(n, generator=generator, device=R.device)
        pi, pj = perm[:n // 2], perm[n // 2:2 * (n // 2)]
    else:
        raise ValueError(f"unknown GCD method {method!r}")
    theta = -lr * A[pi, pj] / math.sqrt(2.0)
    c, s = torch.cos(theta), torch.sin(theta)
    ri, rj = R[:, pi], R[:, pj]
    out = R.clone()
    out[:, pi] = c * ri + s * rj
    out[:, pj] = c * rj - s * ri
    return out


def train(params: dict, batches, model: dict, opt: dict,
          generator: torch.Generator, device, precision: str = "float32"
          ) -> dict:
    """Run one step per batch on ``device`` from ``params`` (copied there,
    not changed). Returns each step's loss, each leaf's first clipped
    gradient norm and each leaf's norm of change after the last step."""
    mm = matmul(precision)
    p = {k: v.to(device, copy=True).requires_grad_(True)
         for k, v in params.items()}
    names = list(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    losses, first = [], {}
    for t, (hist, pos) in enumerate(batches, start=1):
        value = loss(p, hist, pos, model, precision)
        grads = torch.autograd.grad(value, [p[k] for k in names])
        losses.append(float(value.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9),
                               max=1.0)
            grads = {k: g * clip for k, g in zip(names, grads)}
            if t == 1:
                first = {k: float(torch.linalg.vector_norm(g))
                         for k, g in grads.items()}
            b1c = 1.0 - float(np.float32(b1) ** np.float32(t))
            b2c = 1.0 - float(np.float32(b2) ** np.float32(t))
            for k in names:
                if k == MANIFOLD:
                    continue
                g = grads[k]
                m[k].mul_(b1).add_(g * (1.0 - b1))
                v2[k].mul_(b2).add_(g * g * (1.0 - b2))
                upd = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + eps)
                p[k].sub_(opt["lr"] * upd)
            p[MANIFOLD].copy_(gcd_step(p[MANIFOLD], grads[MANIFOLD],
                                       opt["rotation_lr"],
                                       opt["rotation_method"], generator, mm))
    change = {k: float(torch.linalg.vector_norm(p[k].detach()
                                                - params[k].to(device)))
              for k in names}
    return dict(losses=losses, grad_norms=first, change_norms=change)
