"""Structured (slack-eliminated Schur) IPM vs the generic IPM."""

import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm import (
    solve_qp)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
    solve_mpc_qp)


def _structured_instance(seed, n=12, m1=10, m2=8):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    P_uu = L @ L.T + np.eye(n)
    q_u = rng.normal(size=n)
    G_u = rng.normal(size=(m1, n))
    h1 = rng.uniform(0.2, 2.0, size=m1)
    A = rng.normal(size=(m2, n))
    b = rng.uniform(-1.0, 1.0, size=m2)
    p_ss, q_s = 100.0, 50.0
    return P_uu, q_u, G_u, h1, A, b, p_ss, q_s


def _as_generic(P_uu, q_u, G_u, h1, A, b, p_ss, q_s):
    """Assemble the same problem for the generic dense solver."""
    n = P_uu.shape[0]
    m1, m2 = G_u.shape[0], A.shape[0]
    P = np.zeros((n + m2, n + m2))
    P[:n, :n] = P_uu
    P[n:, n:] = p_ss * np.eye(m2)
    q = np.concatenate([q_u, q_s * np.ones(m2)])
    G = np.vstack([
        np.hstack([G_u, np.zeros((m1, m2))]),
        np.hstack([A, -np.eye(m2)]),
        np.hstack([np.zeros((m2, n)), -np.eye(m2)]),
    ])
    h = np.concatenate([h1, b, np.zeros(m2)])
    return P, q, G, h


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_structured_matches_generic(seed):
    data = _structured_instance(seed)
    sol = solve_mpc_qp(*[jnp.asarray(x) for x in data[:6]], data[6], data[7])
    P, q, G, h = _as_generic(*data)
    gen = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(G),
                   jnp.asarray(h))
    assert bool(sol.converged) and bool(gen.converged)
    n = data[0].shape[0]
    # Both stop at merit < 1e-9 (relative); along nearly-flat directions
    # the iterates can differ ~1e-4 while objectives agree to ~1e-8.
    # The tight accuracy authority is the scipy-oracle comparison in
    # test_mpc_filter.py::test_filter_matches_scipy_oracle.
    np.testing.assert_allclose(np.asarray(sol.u), np.asarray(gen.z[:n]),
                               atol=3e-4)
    np.testing.assert_allclose(np.asarray(sol.s), np.asarray(gen.z[n:]),
                               atol=3e-4)
    assert float(sol.obj) == pytest.approx(float(gen.obj), abs=1e-5)


def test_structured_no_box_rows():
    """m1 = 0 (no bounds) works: empty G_u block."""
    data = _structured_instance(7, m1=0)
    P_uu, q_u, G_u, h1, A, b, p_ss, q_s = data
    sol = solve_mpc_qp(jnp.asarray(P_uu), jnp.asarray(q_u),
                       jnp.zeros((0, P_uu.shape[0])), jnp.zeros((0,)),
                       jnp.asarray(A), jnp.asarray(b), p_ss, q_s)
    assert bool(sol.converged)
    P, q, G, h = _as_generic(P_uu, q_u, np.zeros((0, P_uu.shape[0])),
                             np.zeros(0), A, b, p_ss, q_s)
    gen = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(G),
                   jnp.asarray(h))
    np.testing.assert_allclose(np.asarray(sol.u),
                               np.asarray(gen.z[:P_uu.shape[0]]), atol=2e-6)


def test_structured_slack_semantics():
    """At the optimum s = max(0, Au - b) (penalized slacks never inflate)."""
    data = _structured_instance(11)
    sol = solve_mpc_qp(*[jnp.asarray(x) for x in data[:6]], data[6], data[7])
    A, b = data[4], data[5]
    viol = A @ np.asarray(sol.u) - b
    np.testing.assert_allclose(np.asarray(sol.s), np.maximum(viol, 0.0),
                               atol=1e-6)


def test_structured_float32():
    data = _structured_instance(3)
    args32 = [jnp.asarray(x, jnp.float32) for x in data[:6]]
    sol = solve_mpc_qp(*args32, data[6], data[7])
    assert bool(sol.converged)
    sol64 = solve_mpc_qp(*[jnp.asarray(x) for x in data[:6]], data[6],
                         data[7])
    np.testing.assert_allclose(np.asarray(sol.u), np.asarray(sol64.u),
                               atol=5e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linsolve_inv_matches_chol(seed):
    """The matmul-shaped explicit-inverse Newton path ("inv") must agree
    with the triangular-solve path ("chol") to solver accuracy."""
    data = _structured_instance(seed)
    args = [jnp.asarray(x) for x in data[:6]] + [data[6], data[7]]
    a = solve_mpc_qp(*args, linsolve="chol")
    b = solve_mpc_qp(*args, linsolve="inv")
    assert bool(a.converged) and bool(b.converged)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=3e-4)
    assert float(a.obj) == pytest.approx(float(b.obj), abs=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_warm_start_same_optimum_fewer_iterations(seed):
    """Seeding a solve from a RELATED solve's iterates (perturbed rhs,
    as in the pipeline's metric axis) must reach the same optimum in
    strictly fewer IPM iterations (round-4 verdict next #4a)."""
    data = _structured_instance(seed)
    args = [jnp.asarray(x) for x in data[:6]] + [data[6], data[7]]
    base = solve_mpc_qp(*args)
    assert bool(base.converged)

    # Perturb the soft-constraint offsets (the metric axis changes only
    # hs_g, which lands in b).
    args_p = list(args)
    args_p[5] = args[5] + 0.05
    cold = solve_mpc_qp(*args_p)
    warm = solve_mpc_qp(*args_p, warm=(base.u, base.s, *base.mults))
    assert bool(cold.converged) and bool(warm.converged)
    np.testing.assert_allclose(np.asarray(warm.u), np.asarray(cold.u),
                               rtol=1e-5, atol=1e-6)
    assert float(warm.obj) == pytest.approx(float(cold.obj), abs=1e-6)
    assert int(warm.iterations) < int(cold.iterations)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polish_corrects_misclassified_active_set(seed):
    """Started from an active set with rows classified wrongly (as a
    float32 IPM merit floor can leave them, l/w near 1), the polish's
    active-set corrections still land on the optimum."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
        _polish)
    data = _structured_instance(seed)
    P_uu, q_u, G_u, h1, A, b = [jnp.asarray(x) for x in data[:6]]
    m2 = A.shape[0]
    p_ss = jnp.full((m2,), data[6])
    q_s = jnp.full((m2,), data[7])
    sol = solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, data[6], data[7])
    l1, l2, l3 = sol.mults
    w1, w2, w3 = h1 - G_u @ sol.u, b - A @ sol.u + sol.s, sol.s
    # Swap l and w on two rows of each family: active rows read as
    # inactive and inactive rows as active.
    swap = lambda l, w: (l.at[:2].set(w[:2]), w.at[:2].set(l[:2]))
    (l1, w1), (l2, w2), (l3, w3) = swap(l1, w1), swap(l2, w2), swap(l3, w3)
    u_p = _polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, 1e-10,
                  sol.u, sol.s, l1, l2, l3, w1, w2, w3)[0]
    np.testing.assert_allclose(np.asarray(u_p), np.asarray(sol.u),
                               atol=1e-7)
