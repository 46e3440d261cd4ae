"""Fault-tolerant checkpoints (port of ``repro/training/checkpoint.py``).

The on-disk contract is the JAX package's, so a checkpoint of the same
parameter tree reads back in either package:

  * ``<dir>/step_XXXXXXXXXX/arrays.npz`` holds the tree's leaves as numpy
    arrays, keyed by their paths joined by ``/`` (dict keys, sequence
    indices, NamedTuple field names; a ``{"index/R": ...}`` dict and a
    nested ``{"index": {"R": ...}}`` give the same key);
  * ``manifest.json`` (step, time, sorted keys, metadata) is written last,
    inside a ``.tmp`` directory that is then renamed into place, so a crash
    mid-write leaves only an ignorable partial directory;
  * ``save_async`` copies the leaves to the host on the caller's thread and
    writes on a background thread;
  * the ``keep_n`` newest complete checkpoints are kept.

A leaf is a tensor, a numpy array or a Python scalar. An ``nn.Module`` is
saved as the dict of its parameters under their path keys. ``restore``
puts each tensor on the device, and in the dtype, of the leaf it replaces
in ``like``; a bfloat16 tensor is stored as float32, which holds it
exactly.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node):
    """(path entry, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, nn.Module):
        return [(n.replace(".", _SEP), p)
                for n, p in node.named_parameters()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=str)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy())     # a copy, on the CPU too
    return np.array(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    items = _items(tree)
    if items is None:
        if tree is None:
            return {}
        return {prefix: _host(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         keep_n: int = 3) -> str:
    """Blocking save. Returns the checkpoint's path."""
    return _write(ckpt_dir, step, _flatten(tree), metadata, keep_n)


def _write(ckpt_dir: str, step: int, arrays: dict[str, np.ndarray],
           metadata: dict | None, keep_n: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(ckpt_dir, keep_n)
    return final


_PENDING: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
               keep_n: int = 3) -> threading.Thread:
    """Non-blocking save: the leaves are copied to the host on this thread
    (so later in-place updates cannot reach the checkpoint), the file is
    written on a background thread."""
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, _flatten(tree), metadata,
                               keep_n),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def _cleanup(ckpt_dir: str, keep_n: int) -> None:
    done = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    for d in done[:-keep_n]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint (manifest present), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _rebuild(like, data, prefix: str):
    items = _items(like)
    if items is None:
        if like is None:
            return None
        arr = data[prefix]
        if isinstance(like, torch.Tensor):
            if arr.shape != tuple(like.shape):
                raise ValueError(f"checkpoint mismatch at {prefix}: "
                                 f"{arr.shape} vs {tuple(like.shape)}")
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        if isinstance(like, np.ndarray):
            if arr.shape != like.shape:
                raise ValueError(f"checkpoint mismatch at {prefix}: "
                                 f"{arr.shape} vs {like.shape}")
            return np.array(arr)
        return type(like)(arr.item())     # a Python scalar (a step count)
    kids = {k: _rebuild(v, data, f"{prefix}{_SEP}{k}" if prefix else k)
            for k, v in items}
    if isinstance(like, (nn.Module, dict)):
        return kids if isinstance(like, nn.Module) else {
            k: kids[str(k)] for k in like}
    vals = [kids[k] for k, _ in items]
    if _is_namedtuple(like):
        return type(like)(*vals)
    return type(like)(vals)


def restore(ckpt_dir: str, step: int, like) -> tuple[Any, dict]:
    """(tree, manifest): the checkpoint at ``step`` in the structure of
    ``like``, each tensor on its ``like`` leaf's device and dtype (an
    ``nn.Module`` comes back as the dict of its parameters by path key)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = _rebuild(like, data, "")
    return tree, manifest


def restore_latest(ckpt_dir: str, like):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, like)
