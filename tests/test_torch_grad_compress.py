"""The port's error-feedback int8 all-reduce (``training.grad_compress``)
against the JAX package's on the same numpy arrays.

``ef_quantize`` bit for bit against the JAX function; the JAX test of its
error feedback (``tests/test_training.py``) on the port; ``ef_psum_int8``
through ``make_compressed_crosspod_psum`` in gloo process groups of 2 and
4 ranks (``torch.multiprocessing`` spawn, each rank its own slice) over
three steps of error feedback, bit for bit against the JAX function run
under ``jax.vmap(..., axis_name="pod")`` on the stacked arrays, including
equal gradients whose int8 sum wraps in both packages (ROADMAP.md,
"Reference caveats"). No ``XLA_FLAGS`` is set: vmap's named axis needs one
device.
"""
from __future__ import annotations

import os
import socket
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.training import grad_compress as jgc
from repro_torch.training import grad_compress as gc

STEPS = 3
#: seconds a process group may take to run every case
RANKS_TIMEOUT = 120


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis_size", [1, 2, 8])
def test_ef_quantize_matches_jax_bit_for_bit(axis_size):
    """q, scale and the new error equal the JAX function's bits, from a
    zero error and from a carried one, at three scales of gradient."""
    rng = np.random.RandomState(axis_size)
    for scale in (1e-3, 1.0, 40.0):
        x = (rng.randn(1000) * scale).astype(np.float32)
        err = (rng.randn(1000) * scale * 0.01).astype(np.float32)
        for e in (np.zeros_like(err), err):
            jq, js, je = jgc.ef_quantize(jnp.asarray(x), jnp.asarray(e),
                                         axis_size)
            q, s, ne = gc.ef_quantize(_t(x), _t(e), axis_size)
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert s.item() == float(js)
            np.testing.assert_array_equal(ne.numpy(), np.asarray(je))


def test_ef_compression_unbiased_over_time():
    """The JAX test on the port: with error feedback the long-run average
    of the dequantized payload matches full precision."""
    rng = np.random.RandomState(0)
    g_true = _t(rng.randn(256).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc_q = np.zeros(256)
    acc_t = np.zeros(256)
    for _ in range(100):
        q, scale, err = gc.ef_quantize(g_true, err, axis_size=2)
        acc_q += q.numpy().astype(np.float32) * float(scale) * 2
        acc_t += g_true.numpy()
    np.testing.assert_allclose(acc_q / 100, acc_t / 100, atol=1e-2)


def _cases(n: int) -> dict:
    """Per-step, per-rank gradients (STEPS, n, d) and first errors (n, d):
    ``random`` (each rank its own gradient, errors carried from nonzero
    ones) and ``equal`` (every rank the same gradient, largest entry
    positive, from zero errors: its first sum wraps)."""
    rng = np.random.RandomState(100 + n)
    d = 257
    random = (rng.randn(STEPS, n, d) * rng.uniform(0.5, 3.0, (STEPS, n, 1))
              ).astype(np.float32)
    one = np.clip(rng.randn(d), -2.5, 2.5).astype(np.float32)
    one[d // 3] = 2.553
    equal = np.broadcast_to(one, (STEPS, n, d)).copy()
    return {"random": (random, (rng.randn(n, d) * 0.01).astype(np.float32)),
            "equal": (equal, np.zeros((n, d), np.float32))}


def _ranks(rank: int, n: int, port: int, out: str, cases: dict) -> None:
    """One rank of a gloo group: every case's STEPS steps through the
    port's reducer, each step's sum and error saved."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        f = gc.make_compressed_crosspod_psum()
        saved = {}
        for name, (G, E0) in cases.items():
            err = _t(E0[rank])
            for s in range(STEPS):
                g_out, err = f(_t(G[s, rank]), err)
                saved[f"{name}/{s}/g"] = g_out.numpy()
                saved[f"{name}/{s}/err"] = err.numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(n: int, cases: dict, out: str) -> None:
    ctx = tmp.start_processes(_ranks, args=(n, _free_port(), out, cases),
                              nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"{n} gloo ranks did not finish in "
                        f"{RANKS_TIMEOUT} s")


@pytest.mark.parametrize("n", [2, 4])
def test_ef_psum_int8_matches_jax_under_vmap_bit_for_bit(n):
    """n gloo ranks, three steps of error feedback: every rank's sum and
    error equal the JAX ``ef_psum_int8`` under ``vmap(axis_name="pod")``
    bit for bit; the sum is the same on every rank; the equal-gradient
    case wraps at its peak in both packages (a negative sum of positive
    gradients there) and the random case stays within the int8 step of
    the float32 sum."""
    cases = _cases(n)
    f = jax.vmap(lambda g, e: jgc.ef_psum_int8(g, e, "pod", n),
                 axis_name="pod")
    with tempfile.TemporaryDirectory() as out:
        _run_ranks(n, cases, out)
        got = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
               for r in range(n)]
    for name, (G, E0) in cases.items():
        err = jnp.asarray(E0)
        for s in range(STEPS):
            want_g, err = f(jnp.asarray(G[s]), err)
            want_g, want_e = np.asarray(want_g), np.asarray(err)
            for r in range(n):
                np.testing.assert_array_equal(got[r][f"{name}/{s}/g"],
                                              want_g[r], err_msg=(name, s, r))
                np.testing.assert_array_equal(got[r][f"{name}/{s}/err"],
                                              want_e[r], err_msg=(name, s, r))
                np.testing.assert_array_equal(got[r][f"{name}/{s}/g"],
                                              got[0][f"{name}/{s}/g"])
        peak = int(np.argmax(G[0, 0]))
        first = got[0][f"{name}/0/g"]
        true_sum = (G[0] + E0).sum(axis=0)
        if name == "equal":
            assert true_sum[peak] > 0 > first[peak], (true_sum[peak],
                                                      first[peak])
            np.testing.assert_allclose(first[peak], -128 * n * 2.553 / 127,
                                       rtol=1e-6)
        else:
            # each rank's code is within half a step, s·n/2, of its x
            step = n * np.abs(G[0] + E0).max() / 127
            assert np.abs(first - true_sum).max() <= n * step / 2 * 1.001
