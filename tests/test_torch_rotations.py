"""The port's rotation core (``repro_torch.core``, ``repro_torch.rotations``)
against the JAX package, on the CPU, from the same numpy-seeded inputs.

The learner tests use a Hadamard rotation and a dyadic gradient, so every
entry of A = GᵀR − RᵀG is exact in float32 whatever the summation order:
the JAX ``gcd_score`` kernel (interpret mode at n = 256) and the port's
plain product then hand the greedy matching identical scores, ties and all,
and the two learners must pick the same pairs. With random float inputs a
last-bit difference in A could legitimately reorder two near-equal edges.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rotations as jrot
from repro.core import givens as jgivens
from repro.core import matching as jmatching
from repro_torch import rotations as trot
from repro_torch.core import givens as tgivens
from repro_torch.core import matching as tmatching


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _hadamard(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix over √n: orthogonal, entries ±1/√n, exact
    in float32 for n a power of four."""
    H = np.ones((1, 1))
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return (H / np.sqrt(n)).astype(np.float32)


def _dyadic_grad(rng: np.random.RandomState, n: int) -> np.ndarray:
    return (rng.randint(-4, 5, size=(n, n)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("n", [16, 64])
def test_directional_derivs_matches_jax(n):
    rng = np.random.RandomState(n)
    G = (rng.randn(n, n) / np.sqrt(n)).astype(np.float32)
    R = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
    want = np.asarray(jgivens.directional_derivs(jnp.asarray(G),
                                                 jnp.asarray(R)))
    got = tgivens.directional_derivs(_t(G), _t(R))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_apply_pair_rotations_matches_jax(lead):
    rng = np.random.RandomState(len(lead))
    n = 12
    X = rng.randn(*lead, n).astype(np.float32)
    perm = rng.permutation(n)
    pi, pj = perm[:5].astype(np.int32), perm[5:10].astype(np.int32)
    theta = rng.uniform(-1, 1, size=5).astype(np.float32)
    want = np.asarray(jgivens.apply_pair_rotations(
        jnp.asarray(X), jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(theta)))
    got = tgivens.apply_pair_rotations(_t(X), _t(pi), _t(pj), _t(theta))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    untouched = perm[10:]
    np.testing.assert_array_equal(got.numpy()[..., untouched],
                                  X[..., untouched])


def _pair_set(pi, pj) -> set:
    return {tuple(sorted(p)) for p in zip(np.asarray(pi).tolist(),
                                          np.asarray(pj).tolist())}


@pytest.mark.parametrize("n", [8, 32, 65])
def test_greedy_matching_fast_matches_jax(n):
    rng = np.random.RandomState(n)
    M = rng.randn(n, n).astype(np.float32)
    A = M - M.T                                  # continuous: no ties
    jpi, jpj = jmatching.greedy_matching_fast(jnp.asarray(A))
    tpi, tpj = tmatching.greedy_matching_fast(_t(A))
    assert _pair_set(tpi, tpj) == _pair_set(jpi, jpj)
    assert len(tpi) == n // 2
    np.testing.assert_allclose(
        float(tmatching.matching_weight(_t(A), tpi, tpj)),
        float(jmatching.matching_weight(jnp.asarray(A), jpi, jpj)),
        rtol=1e-6)
    # the one-edge-at-a-time scan is the fast variant's oracle
    opi, opj = tmatching.greedy_matching(_t(A))
    assert _pair_set(opi, opj) == _pair_set(tpi, tpj)


def test_greedy_matching_ties_go_to_the_lower_edge():
    """All-equal |A|: both packages take the lowest flat edge index first,
    which pairs (0, 1), (2, 3), ..."""
    n = 8
    A = np.ones((n, n), np.float32) - 2 * np.tril(np.ones((n, n), np.float32))
    jpi, jpj = jmatching.greedy_matching_fast(jnp.asarray(A))
    tpi, tpj = tmatching.greedy_matching_fast(_t(A))
    assert list(zip(tpi.tolist(), tpj.tolist())) == list(
        zip(np.asarray(jpi).tolist(), np.asarray(jpj).tolist()))
    assert _pair_set(tpi, tpj) == {(0, 1), (2, 3), (4, 5), (6, 7)}


def _learners(spec: str, n: int):
    kw = {"sub": 8} if spec == "subspace_gcd" else {}
    return jrot.make(spec, **kw), trot.make(spec, **kw)


@pytest.mark.parametrize("spec", ["gcd_greedy", "subspace_gcd"])
@pytest.mark.parametrize("n", [64, 256])
def test_gcd_update_matches_jax(spec, n):
    """One learner step from the same (G, R): the same pairs, R_new to 1e-6,
    and R_new as orthogonal as the reference's. At n = 256 the JAX learner
    routes A through its gcd_score kernel (interpret mode); the port's
    learner calls ``ops.gcd_score`` at every n, its plain version here."""
    rng = np.random.RandomState(n)
    R = _hadamard(n)
    G = _dyadic_grad(rng, n)
    lr = 2e-3
    jl, tl = _learners(spec, n)
    jstate, jdelta = jl.update(jl.init_from(jnp.asarray(R)), jnp.asarray(G),
                               lr, jax.random.PRNGKey(0))
    tstate, tdelta = tl.update(tl.init_from(_t(R)), _t(G), lr)
    assert _pair_set(tdelta.pi, tdelta.pj) == _pair_set(jdelta.pi, jdelta.pj)
    np.testing.assert_allclose(tdelta.theta.numpy(), np.asarray(jdelta.theta),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tstate.R.numpy(), np.asarray(jstate.R),
                               atol=1e-6, rtol=0)
    assert int(tstate.step) == int(jstate.step) == 1
    assert (float(trot.orthogonality_error(tstate.R))
            <= float(jgivens.orthogonality_error(jstate.R)))
    assert float(np.abs(tstate.R.numpy() - R).max()) > 0
    if spec == "subspace_gcd":
        pi, pj, th = (tdelta.pi.numpy(), tdelta.pj.numpy(),
                      tdelta.theta.numpy())
        assert np.all(th[pi // 8 != pj // 8] == 0.0)


def test_delta_apply_and_identity():
    rng = np.random.RandomState(1)
    X = _t(rng.randn(6, 8).astype(np.float32))
    ident = trot.identity_delta()
    assert torch.equal(trot.apply(X, ident), X)
    d = trot.GivensDelta(pi=torch.tensor([0, 2]), pj=torch.tensor([1, 5]),
                         theta=torch.tensor([0.3, -0.2]))
    want = jrot.apply(jnp.asarray(X.numpy()), jrot.GivensDelta(
        pi=jnp.asarray([0, 2]), pj=jnp.asarray([1, 5]),
        theta=jnp.asarray([0.3, -0.2], jnp.float32)))
    np.testing.assert_allclose(trot.apply(X, d).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def test_registry_ports_only_the_slice():
    assert isinstance(trot.make("gcd_greedy"), trot.GCD)
    assert isinstance(trot.make("subspace_gcd", sub=4), trot.SubspaceGCD)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trot.make("cayley_sgd")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trot.make("gcd_random")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trot.make("gcd_steepest")
    with pytest.raises(TypeError):
        trot.make("gcd_greedy", preconditioner="adam")   # greedy/none only
    with pytest.raises(ValueError):
        trot.make("no_such_learner")
    with pytest.raises(ValueError):
        trot.make("subspace_gcd")                       # needs sub
