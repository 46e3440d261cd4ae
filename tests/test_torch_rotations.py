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
from repro.rotations import cayley as jcayley
from repro_torch import rotations as trot
from repro_torch.core import givens as tgivens
from repro_torch.core import matching as tmatching
from repro_torch.rotations import cayley as tcayley


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
    """Every learner of the JAX registry builds through ``make`` (aliases
    and ``method=`` included) with the JAX registry's tuple in
    ``names()``: the Table 1 rows, Procrustes (and its "svd" alias) and
    the two overlapping ablations; wrong specs still raise."""
    assert isinstance(trot.make("gcd_greedy"), trot.GCD)
    assert isinstance(trot.make("subspace_gcd", sub=4), trot.SubspaceGCD)
    for spec, method in (("gcd_random", "random"), ("gcd_greedy", "greedy"),
                         ("gcd_steepest", "steepest"), ("gcd", "greedy"),
                         ("gcd_overlap_greedy", "overlap_greedy"),
                         ("gcd_overlap_random", "overlap_random")):
        learner = trot.make(spec)
        assert type(learner) is trot.GCD and learner.method == method
    assert trot.make("gcd", method="steepest", sweeps=3) == trot.GCD(
        method="steepest", sweeps=3)
    assert trot.make("subspace_gcd", sub=4, method="random").method == \
        "random"
    assert isinstance(trot.make("cayley_sgd"), trot.CayleySGD)
    assert isinstance(trot.make("cayley"), trot.CayleySGD)
    for spec in ("procrustes", "svd"):
        assert isinstance(trot.make(spec), trot.Procrustes)
    assert trot.names() == jrot.names()
    assert not hasattr(trot, "_LATER")
    assert trot.make("gcd", method="overlap_random").method == \
        "overlap_random"
    assert trot.make("gcd_greedy", preconditioner="adam").preconditioner \
        == "adam"
    with pytest.raises(ValueError, match="disjoint"):
        trot.make("subspace_gcd", sub=4, method="overlap_greedy")
    with pytest.raises(ValueError):
        trot.make("gcd", method="no_such_method")
    with pytest.raises(ValueError):
        trot.make("gcd_greedy", preconditioner="rmsprop")
    with pytest.raises(ValueError):
        trot.make("no_such_learner")
    with pytest.raises(ValueError):
        trot.make("subspace_gcd")                       # needs sub


# -- GCD-S: 2-opt ------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 64, 256])
def test_two_opt_refine_matches_jax(n):
    """From the same pairs on a random float A, the same pair arrays (order
    included) after 16 sweeps: both compute the gains by the same float32
    operations and break argmax ties at the first index. Started from a
    random pairing (which 2-opt improves) and from the greedy matching,
    which the port's ``greedy_matching_fast`` gives pair for pair."""
    rng = np.random.RandomState(100 + n)
    M = rng.randn(n, n).astype(np.float32)
    A = M - M.T
    perm = rng.permutation(n).astype(np.int32)
    gpi, gpj = jmatching.greedy_matching_fast(jnp.asarray(A))
    tgpi, tgpj = tmatching.greedy_matching_fast(_t(A))
    np.testing.assert_array_equal(tgpi.numpy(), np.asarray(gpi))
    np.testing.assert_array_equal(tgpj.numpy(), np.asarray(gpj))
    for pi, pj in ((perm[:n // 2], perm[n // 2:]), (gpi, gpj)):
        jpi, jpj = jmatching.two_opt_refine(jnp.asarray(A), jnp.asarray(pi),
                                            jnp.asarray(pj), sweeps=16)
        tpi, tpj = tmatching.two_opt_refine(_t(A), _t(pi), _t(pj),
                                            sweeps=16)
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(tpj.numpy(), np.asarray(jpj))
        assert (float(tmatching.matching_weight(_t(A), tpi, tpj))
                >= float(tmatching.matching_weight(_t(A), _t(pi), _t(pj))))
    assert _pair_set(jpi, jpj) != _pair_set(perm[:n // 2], perm[n // 2:])


@pytest.mark.parametrize("n", [16, 64])
def test_steepest_matching_matches_jax(n):
    """On a Hadamard R and a dyadic G (A exact, ties and all) GCD-S picks
    the JAX package's pairs, and weighs at least as much as greedy."""
    rng = np.random.RandomState(n + 7)
    R, G = _hadamard(n), _dyadic_grad(rng, n)
    A = np.asarray(jgivens.directional_derivs(jnp.asarray(G),
                                              jnp.asarray(R)))
    jpi, jpj = jmatching.steepest_matching(jnp.asarray(A))
    tpi, tpj = tmatching.steepest_matching(_t(A))
    assert _pair_set(tpi, tpj) == _pair_set(jpi, jpj)
    gpi, gpj = tmatching.greedy_matching_fast(_t(A))
    assert (float(tmatching.matching_weight(_t(A), tpi, tpj))
            >= float(tmatching.matching_weight(_t(A), gpi, gpj)))


@pytest.mark.parametrize("n,seed", [(6, 0), (8, 1), (10, 2), (12, 3),
                                    (12, 4)])
def test_greedy_le_steepest_le_exact(n, seed):
    """Greedy ≤ 2-opt ≤ the exact maximum (the JAX package's bitmask DP),
    on fixed seeds; every result is a perfect matching."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n).astype(np.float32)
    A = _t(M - M.T)
    gpi, gpj = tmatching.greedy_matching_fast(A)
    spi, spj = tmatching.steepest_matching(A)
    assert sorted(spi.tolist() + spj.tolist()) == list(range(n))
    _, _, best = jmatching.exact_matching_dp(A.numpy())
    w_g = float(tmatching.matching_weight(A, gpi, gpj))
    w_s = float(tmatching.matching_weight(A, spi, spj))
    assert w_g <= w_s <= best + 1e-5


# -- GCD-R ---------------------------------------------------------------------


def test_random_matching_is_a_seeded_perfect_matching():
    for n in (8, 9, 64):
        pi, pj = tmatching.random_matching(
            torch.Generator().manual_seed(0), n, device="cpu")
        assert len(pi) == len(pj) == n // 2
        both = pi.tolist() + pj.tolist()
        assert len(set(both)) == len(both) and set(both) <= set(range(n))
    a = tmatching.random_matching(torch.Generator().manual_seed(5), 64,
                                  device="cpu")
    b = tmatching.random_matching(torch.Generator().manual_seed(5), 64,
                                  device="cpu")
    c = tmatching.random_matching(torch.Generator().manual_seed(6), 64,
                                  device="cpu")
    assert _pair_set(*a) == _pair_set(*b)
    assert _pair_set(*a) != _pair_set(*c)


def test_gcd_random_step_matches_jax_delta_from_its_pairs():
    """JAX's threefry cannot be drawn in torch, so the port's GCD-R step is
    held to the JAX delta built from the port's own pairs: θ and R_new to
    1e-6. Without a generator GCD-R raises."""
    n = 64
    rng = np.random.RandomState(11)
    R = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
    G = (0.05 * rng.randn(n, n)).astype(np.float32)
    lr = 3e-3
    learner = trot.make("gcd_random")
    with pytest.raises(ValueError, match="Generator"):
        learner.update(learner.init_from(_t(R)), _t(G), lr)
    tstate, tdelta = learner.update(learner.init_from(_t(R)), _t(G), lr,
                                    torch.Generator().manual_seed(3))
    pi = jnp.asarray(tdelta.pi.numpy())
    pj = jnp.asarray(tdelta.pj.numpy())
    A = jgivens.directional_derivs(jnp.asarray(G), jnp.asarray(R))
    theta = -jnp.float32(lr) * A[pi, pj] / jgivens.SQRT2
    jdelta = jrot.GivensDelta(pi=pi, pj=pj, theta=theta)
    np.testing.assert_allclose(tdelta.theta.numpy(), np.asarray(theta),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tstate.R.numpy(),
                               np.asarray(jdelta.apply(jnp.asarray(R))),
                               atol=1e-6, rtol=0)
    _, again = learner.update(learner.init_from(_t(R)), _t(G), lr,
                              torch.Generator().manual_seed(3))
    assert torch.equal(again.pi, tdelta.pi) and torch.equal(again.pj,
                                                             tdelta.pj)


# -- Cayley ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 32])
def test_cayley_and_inverse_match_jax(n):
    rng = np.random.RandomState(n)
    p = (0.1 * rng.randn(n, n)).astype(np.float32)
    want = np.asarray(jcayley.cayley(jnp.asarray(p)))
    got = tcayley.cayley(_t(p))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tcayley.inverse_cayley(got).numpy(),
        np.asarray(jcayley.inverse_cayley(jnp.asarray(want))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcayley.skew_from_params(_t(p)).numpy(),
                               np.asarray(jcayley.skew_from_params(
                                   jnp.asarray(p))), atol=0, rtol=0)
    assert torch.equal(tcayley.init(n, device="cpu"), torch.zeros(n, n))


def _near_minus_one(theta: float, n: int = 8) -> np.ndarray:
    """tests/test_rotations.py's block rotation: its leading plane turns by
    ``theta`` (eigenvalues e^{±iθ} → −1 as θ → π)."""
    R = np.eye(n, dtype=np.float32)
    c, s = np.cos(theta), np.sin(theta)
    R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c
    return R


@pytest.mark.parametrize("theta", [np.pi - 1e-2, np.pi])
def test_inverse_cayley_near_minus_one_matches_jax(theta):
    """Near the −1 eigenvalue the direct solve is kept; at it, the
    regularised one: the port takes the same branch (values to 1e-5) and
    stays finite."""
    R = _near_minus_one(theta)
    want = np.asarray(jcayley.inverse_cayley(jnp.asarray(R)))
    got = tcayley.inverse_cayley(_t(R))
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert bool(torch.all(torch.isfinite(tcayley.cayley(got))))


@pytest.mark.parametrize("case", ["random", "near", "singular"])
def test_stable_solve_matches_jax(case):
    """The direct branch (a random well-posed M, and I + R a hundredth of
    a radian from R's −1 eigenvalue) and the regularised one (I + R for
    an exact half-turn, which is singular), against JAX to 1e-5. An arbitrary singular M is left out: its
    regularised normal equations have a condition number near 1e9, and
    any two float32 solvers disagree there."""
    rng = np.random.RandomState(3)
    B = rng.randn(8, 8).astype(np.float32)
    if case == "random":
        M = rng.randn(8, 8).astype(np.float32) + 3 * np.eye(8,
                                                           dtype=np.float32)
    elif case == "near":
        M = np.eye(8, dtype=np.float32) + _near_minus_one(np.pi - 1e-2).T
    else:                 # an exact half-turn: I + R has two zero rows
        M = np.eye(8, dtype=np.float32) + np.diag(
            [-1, -1, 1, 1, 1, 1, 1, 1]).astype(np.float32)
    want = np.asarray(jcayley.stable_solve(jnp.asarray(M), jnp.asarray(B)))
    got = tcayley.stable_solve(_t(M), _t(B))
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    direct = torch.linalg.solve_ex(_t(M), _t(B))[0]
    assert torch.equal(got, direct) == (case != "singular")


@pytest.mark.parametrize("n", [16, 64])
def test_cayley_sgd_update_matches_jax(n):
    """One Cayley-SGD step from the same (R, G, lr): R_new and the dense
    Δ to 1e-5, R_new no further from orthogonal than 2× the reference."""
    rng = np.random.RandomState(n + 1)
    R = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
    G = (0.05 * rng.randn(n, n)).astype(np.float32)
    lr = 3e-3
    jl, tl = jrot.make("cayley_sgd"), trot.make("cayley_sgd")
    jstate, jdelta = jl.update(jl.init_from(jnp.asarray(R)), jnp.asarray(G),
                               lr, jax.random.PRNGKey(0))
    with torch.no_grad():                       # as the optimizer calls it
        tstate, tdelta = tl.update(tl.init_from(_t(R)), _t(G), lr)
    assert isinstance(tdelta, trot.DenseDelta)
    np.testing.assert_allclose(tdelta.dR.numpy(), np.asarray(jdelta.dR),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tstate.R.numpy(), np.asarray(jstate.R),
                               atol=1e-5, rtol=0)
    assert int(tstate.step) == int(jstate.step) == 1
    assert float(np.abs(tstate.R.numpy() - R).max()) > 1e-6
    assert (float(trot.orthogonality_error(tstate.R))
            <= 2 * float(jgivens.orthogonality_error(jstate.R)))
    X = _t(rng.randn(5, n).astype(np.float32))
    np.testing.assert_allclose(trot.apply(X, tdelta).numpy(),
                               (X @ tdelta.dR).numpy(), atol=0, rtol=0)


def test_cayley_state_round_trip_from_jax():
    from repro_torch import convert

    rng = np.random.RandomState(2)
    n = 16
    jl = jrot.make("cayley_sgd")
    R = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
    jstate, _ = jl.update(jl.init_from(jnp.asarray(R)),
                          jnp.asarray(rng.randn(n, n).astype(np.float32)),
                          1e-3, jax.random.PRNGKey(0))
    st = convert.cayley_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()},
        device="cpu")
    assert isinstance(st, trot.CayleyState)
    assert set(st._fields) == set(jstate._fields)
    np.testing.assert_array_equal(st.R.numpy(), np.asarray(jstate.R))
    assert st.R.dtype == torch.float32 and st.step.dtype == torch.int32
    assert int(st.step) == int(jstate.step) == 1
    back = {k: np.asarray(v) for k, v in st._asdict().items()}
    np.testing.assert_array_equal(back["R"], np.asarray(jstate.R))


# -- the rest of core.givens and core.matching ------------------------------


@pytest.mark.parametrize("n,flip", [(8, False), (8, True), (33, True)])
def test_project_to_so_n_matches_jax(n, flip):
    """The SVD projection lands in SO(n) (det +1, also from a matrix whose
    nearest orthogonal one has det −1) and agrees with JAX's within 1e-5;
    the port's float64 SVD is at least as orthogonal."""
    rng = np.random.RandomState(n + flip)
    M = (np.linalg.qr(rng.randn(n, n))[0] + 0.1 * rng.randn(n, n))
    if flip != (np.linalg.det(M) < 0):
        M[:, 0] *= -1
    M = M.astype(np.float32)
    want = np.asarray(jgivens.project_to_so_n(jnp.asarray(M)))
    got = tgivens.project_to_so_n(_t(M))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(torch.linalg.det(got.double())) - 1.0) < 1e-5
    assert (float(tgivens.orthogonality_error(got))
            <= max(float(jgivens.orthogonality_error(jnp.asarray(want))),
                   1e-6))


def test_random_rotation_is_a_seeded_element_of_so_n():
    g = torch.Generator().manual_seed(3)
    Q = tgivens.random_rotation(g, 24, device="cpu")
    assert Q.shape == (24, 24) and Q.dtype == torch.float32
    assert float(tgivens.orthogonality_error(Q)) < 1e-5
    assert abs(float(torch.linalg.det(Q.double())) - 1.0) < 1e-5
    again = tgivens.random_rotation(torch.Generator().manual_seed(3), 24,
                                    device="cpu")
    assert torch.equal(Q, again)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgivens.random_rotation(g, 4)       # the card by default


def test_pair_products_and_scores_match_jax():
    """``rotation_from_pairs``, ``apply_pair_rotations_transposed``,
    ``gather_pair_scores`` and ``directional_derivs_wrt_input`` against
    their JAX counterparts on shared inputs (1e-6)."""
    rng = np.random.RandomState(9)
    n = 10
    perm = rng.permutation(n)
    pi, pj = perm[:4].astype(np.int32), perm[4:8].astype(np.int32)
    th = rng.uniform(-1, 1, size=4).astype(np.float32)
    X = rng.randn(5, n).astype(np.float32)
    dX = rng.randn(5, n).astype(np.float32)
    A = rng.randn(n, n).astype(np.float32)
    j = [jnp.asarray(a) for a in (pi, pj, th)]
    t = [_t(a) for a in (pi, pj, th)]
    np.testing.assert_allclose(
        tgivens.rotation_from_pairs(*t, n).numpy(),
        np.asarray(jgivens.rotation_from_pairs(*j, n)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tgivens.apply_pair_rotations_transposed(_t(X), *t).numpy(),
        np.asarray(jgivens.apply_pair_rotations_transposed(
            jnp.asarray(X), *j)), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tgivens.gather_pair_scores(_t(A), t[0], t[1]).numpy(),
        np.asarray(jgivens.gather_pair_scores(jnp.asarray(A), j[0], j[1])))
    np.testing.assert_allclose(
        tgivens.directional_derivs_wrt_input(_t(X), _t(dX)).numpy(),
        np.asarray(jgivens.directional_derivs_wrt_input(
            jnp.asarray(X), jnp.asarray(dX))), atol=1e-6, rtol=0)
    # a rotation and its transpose undo each other
    Rp = tgivens.rotation_from_pairs(*t, n)
    back = tgivens.apply_pair_rotations_transposed(Rp, *t)
    np.testing.assert_allclose(back.numpy(), np.eye(n), atol=1e-6)


@pytest.mark.parametrize("n,k", [(8, None), (32, None), (32, 40)])
def test_overlapping_topk_matches_jax(n, k):
    """On distinct |A| the port picks JAX's pairs in JAX's order; on an
    all-equal field both take the lowest flat edge indices first."""
    rng = np.random.RandomState(n)
    M = rng.randn(n, n).astype(np.float32)
    A = M - M.T
    jpi, jpj = jmatching.overlapping_topk(jnp.asarray(A), k)
    tpi, tpj = tmatching.overlapping_topk(_t(A), k)
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(tpj.numpy(), np.asarray(jpj))
    assert bool(torch.all(tpi < tpj))
    ones = np.ones((n, n), np.float32)
    jpi, jpj = jmatching.overlapping_topk(jnp.asarray(ones), k)
    tpi, tpj = tmatching.overlapping_topk(_t(ones), k)
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(tpj.numpy(), np.asarray(jpj))


def test_overlapping_random_is_seeded_and_never_pairs_an_axis_with_itself():
    """By property (JAX's PRNG cannot be reproduced): k pairs lo < hi in
    [0, n), repeats allowed, the same pairs from the same seed."""
    for n, k in ((2, None), (7, 50), (64, None)):
        g = torch.Generator().manual_seed(n)
        lo, hi = tmatching.overlapping_random(g, n, k, device="cpu")
        want = n // 2 if k is None else k
        assert lo.shape == hi.shape == (want,)
        assert bool(torch.all((0 <= lo) & (lo < hi) & (hi < n)))
        lo2, hi2 = tmatching.overlapping_random(
            torch.Generator().manual_seed(n), n, k, device="cpu")
        assert torch.equal(lo, lo2) and torch.equal(hi, hi2)
    lo, _ = tmatching.overlapping_random(torch.Generator().manual_seed(0),
                                         8, 400, device="cpu")
    assert len(set(lo.tolist())) > 1 and lo.unique().numel() < 400


@pytest.mark.parametrize("n", [2, 4, 6, 8, 10])
def test_exact_matching_dp_matches_jax(n):
    rng = np.random.RandomState(n)
    M = rng.randn(n, n).astype(np.float32)
    A = M - M.T
    jpi, jpj, jw = jmatching.exact_matching_dp(A)
    tpi, tpj, tw = tmatching.exact_matching_dp(_t(A))
    np.testing.assert_array_equal(tpi, jpi)
    np.testing.assert_array_equal(tpj, jpj)
    assert tw == jw
    assert tw >= float(tmatching.matching_weight(
        _t(A), *tmatching.greedy_matching_fast(_t(A)))) - 1e-5


def test_overlapping_delta_matches_jax_sequential_apply():
    """GivensDelta(overlapping=True) composes shared-axis pairs one after
    another as JAX's ``_apply_overlapping`` does (1e-6), leaves its input
    as it was, and differs from treating the pairs as commuting."""
    from repro.rotations import base as jbase

    rng = np.random.RandomState(4)
    n = 9
    pi = np.array([0, 1, 0, 3, 3, 8], np.int32)
    pj = np.array([1, 2, 5, 4, 7, 2], np.int32)
    th = rng.uniform(-1, 1, size=6).astype(np.float32)
    for lead in ((), (4,), (2, 3)):
        X = rng.randn(*lead, n).astype(np.float32)
        want = np.asarray(jbase._apply_overlapping(
            jnp.asarray(X), jnp.asarray(pi), jnp.asarray(pj),
            jnp.asarray(th)))
        Xt = _t(X)
        got = trot.apply(Xt, trot.GivensDelta(_t(pi), _t(pj), _t(th),
                                              overlapping=True))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(Xt.numpy(), X)
    R = trot.apply(torch.eye(n), trot.GivensDelta(
        _t(pi), _t(pj), _t(th), overlapping=True))
    assert float(trot.orthogonality_error(R)) < 1e-6


# -- preconditioned GCD, the overlap methods, Procrustes --------------------


@pytest.mark.parametrize("spec,kw", [("gcd_greedy", {"preconditioner":
                                                      "adagrad"}),
                                     ("gcd_greedy", {"preconditioner":
                                                     "adam"}),
                                     ("gcd_overlap_greedy", {}),
                                     ("procrustes", {})])
def test_three_learner_steps_match_jax(spec, kw):
    """Three updates, each from the JAX state after the last carried across
    by ``convert`` (the accumulators included) and a fresh dyadic G, from
    a Hadamard R: the same pairs and angles (1e-6) and the same state (R,
    step, accum, accum2 to 1e-5; Procrustes' float64 SVD against JAX's
    float32 one to 1e-5)."""
    from repro_torch import convert

    n = 16
    rng = np.random.RandomState(len(spec) + len(kw))
    jl, tl = jrot.make(spec, **kw), trot.make(spec, **kw)
    jstate = jl.init_from(jnp.asarray(_hadamard(n)))
    to_t = (convert.procrustes_state_from_numpy if spec == "procrustes"
            else convert.gcd_state_from_numpy)
    for step in range(3):
        G = _dyadic_grad(rng, n)
        tstate = to_t({k: np.asarray(v)
                       for k, v in jstate._asdict().items()}, device="cpu")
        jstate, jdelta = jl.update(jstate, jnp.asarray(G), 5e-2,
                                   jax.random.PRNGKey(step))
        tstate, tdelta = tl.update(tstate, _t(G), 5e-2)
        assert type(tstate).__name__ == type(jstate).__name__
        for f in jstate._fields:
            np.testing.assert_allclose(
                getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                atol=1e-5, rtol=1e-5, err_msg=f"{spec} {kw} step {step} {f}")
        if spec == "procrustes":
            assert isinstance(tdelta, trot.DenseDelta)
            np.testing.assert_allclose(tdelta.dR.numpy(),
                                       np.asarray(jdelta.dR), atol=1e-5)
            continue
        assert tdelta.overlapping == jdelta.overlapping
        np.testing.assert_array_equal(tdelta.pi.numpy(), np.asarray(jdelta.pi))
        np.testing.assert_array_equal(tdelta.pj.numpy(), np.asarray(jdelta.pj))
        np.testing.assert_allclose(tdelta.theta.numpy(),
                                   np.asarray(jdelta.theta), atol=1e-6,
                                   rtol=0)
    assert float(trot.orthogonality_error(tstate.R)) < 1e-5


def test_procrustes_solve_is_the_closed_form():
    rng = np.random.RandomState(2)
    X = rng.randn(50, 8).astype(np.float32)
    Y = (X @ np.linalg.qr(rng.randn(8, 8))[0]).astype(np.float32)
    learner = trot.make("svd")
    st = learner.init(8, device="cpu")
    st, delta = learner.solve(st, _t(X), _t(Y))
    jl = jrot.make("procrustes")
    js, jd = jl.solve(jl.init(8), jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(st.R.numpy(), np.asarray(js.R), atol=1e-5)
    np.testing.assert_allclose(delta.dR.numpy(), np.asarray(jd.dR),
                               atol=1e-5)
    assert int(st.step) == 1


@pytest.mark.parametrize("spec", ["gcd_greedy", "cayley_sgd"])
def test_reorthonormalize_every_fires_only_on_its_steps(spec, monkeypatch):
    """Every 3rd step (post-update counter 3, 6) the state's R is the SVD
    projection of the delta-applied R, and no SVD runs on the other
    steps; every = 0 never projects."""
    from repro_torch.rotations import base as tbase

    calls = []
    real = tbase.givens.project_to_so_n

    def spy(R):
        calls.append(R.clone())
        return real(R)

    monkeypatch.setattr(tbase.givens, "project_to_so_n", spy)
    rng = np.random.RandomState(5)
    n = 8
    learner = trot.make(spec, reorthonormalize_every=3)
    st = learner.init(n, device="cpu")
    for step in range(1, 8):
        before = len(calls)
        R_old = st.R
        st, delta = learner.update(st, _t(rng.randn(n, n).astype(
            np.float32)), 1e-2)
        fired = len(calls) > before
        assert fired == (step % 3 == 0), step
        moved = trot.apply(R_old, delta)
        if fired:
            torch.testing.assert_close(calls[-1], moved)
            torch.testing.assert_close(st.R, real(moved))
        else:
            assert torch.equal(st.R, moved)
    off = trot.make(spec)
    st = off.init(n, device="cpu")
    for _ in range(4):
        st, _ = off.update(st, _t(rng.randn(n, n).astype(np.float32)), 1e-2)
    assert len(calls) == 2
    R = _t(np.linalg.qr(rng.randn(n, n))[0].astype(np.float32) * 1.01)
    assert torch.equal(trot.maybe_reorthonormalize(R, torch.tensor(4), 0), R)
    assert torch.equal(trot.maybe_reorthonormalize(R, torch.tensor(4), 3), R)
    fixed = trot.maybe_reorthonormalize(R, torch.tensor(6), 3)
    assert float(trot.orthogonality_error(fixed)) < 1e-5


def test_learners_follow_the_protocol():
    for spec in trot.names():
        kw = {"sub": 4} if spec == "subspace_gcd" else {}
        learner = trot.make(spec, **kw)
        assert isinstance(learner, trot.RotationLearner), spec
        st = learner.init(8, device="cpu")
        assert torch.equal(learner.materialize(st), torch.eye(8))
        R = tgivens.random_rotation(torch.Generator().manual_seed(0), 8,
                                    device="cpu")
        st = learner.with_rotation(st, R)
        st, delta = learner.update(st, torch.ones(8, 8), 1e-2,
                                   torch.Generator().manual_seed(1))
        torch.testing.assert_close(trot.apply(R, delta),
                                   learner.materialize(st), atol=1e-6,
                                   rtol=0)
