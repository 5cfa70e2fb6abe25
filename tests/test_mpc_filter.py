"""MPC safety-filter golden and property tests
(reference core/mpc_filter.py:40-218)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.dynamics import (
    create_double_integrator_matrices)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.mpc_filter import (
    build_mpc_problem, filter_trajectory)
from oracle import mpc_qp_oracle

DT, H = 0.2, 12  # short horizon keeps the scipy oracle fast
Q_W, R_W = 2.0, 1.0


def _setup(n_obs=1, seed=0):
    rng = np.random.default_rng(seed)
    A, B, C = create_double_integrator_matrices(DT, dtype=jnp.float64)
    prob = build_mpc_problem(A, B, C, Q_W, R_W, H, n_obs)
    x0 = np.array([-4.0, 0.0, 0.0, 0.0])
    # straight-line-ish reference
    x_ref = np.zeros((H + 1, 4))
    x_ref[:, 0] = -4.0 + 0.3 * np.arange(H + 1)
    x_ref[:, 2] = 1.5
    u_ref = np.zeros((H, 2))
    # halfspaces blocking part of the path
    hs_h = rng.normal(size=(H, n_obs, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = rng.uniform(-1.0, 0.5, size=(H, n_obs))
    return prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g


@pytest.mark.parametrize("n_obs", [1, 3])
def test_filter_matches_scipy_oracle(n_obs):
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(n_obs)
    u_min = np.array([-5.0, -5.0]); u_max = np.array([5.0, 5.0])
    p_min = np.array([-10.0, -10.0]); p_max = np.array([10.0, 10.0])

    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g),
                            input_bounds=(u_min, u_max),
                            position_bounds=(p_min, p_max))
    u_oracle, s_oracle, obj_oracle = mpc_qp_oracle(
        np.asarray(A), np.asarray(B), np.asarray(C), Q_W, R_W, H,
        x0, x_ref, hs_h, hs_g, u_min, u_max, p_min, p_max)

    assert bool(res.status)
    assert not bool(res.used_fallback)
    np.testing.assert_allclose(np.asarray(res.u_filtered), u_oracle,
                               atol=2e-5)
    assert float(res.objective) == pytest.approx(obj_oracle, rel=1e-6)


def test_filtered_trajectory_satisfies_dynamics():
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup()
    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g))
    x = np.asarray(res.x_filtered)
    u = np.asarray(res.u_filtered)
    A_np, B_np = np.asarray(A), np.asarray(B)
    for t in range(H):
        np.testing.assert_allclose(x[t + 1], A_np @ x[t] + B_np @ u[t],
                                   atol=1e-10)


def test_input_bounds_respected():
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=3)
    u_min = np.array([-0.5, -0.5]); u_max = np.array([0.5, 0.5])
    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g),
                            input_bounds=(u_min, u_max))
    u = np.asarray(res.u_filtered)
    assert (u <= 0.5 + 1e-7).all() and (u >= -0.5 - 1e-7).all()


def test_slack_nonnegative_and_consistent():
    """Slacks equal max(0, violation) at the optimum (they are penalized,
    so the QP never inflates them)."""
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=4)
    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g))
    s = np.asarray(res.slack)
    assert (s >= -1e-8).all()
    pos = np.asarray(res.x_filtered)[1:, :2]
    viol = np.einsum("tjd,td->tj", hs_h, pos) + hs_g
    np.testing.assert_allclose(s, np.maximum(viol, 0.0), atol=1e-5)


def test_bounds_trimming_quirk():
    """4-vector bounds passed as position bounds are trimmed to 2 dims
    (reference core/mpc_filter.py:102-108 / main.py:112)."""
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=5)
    full = (np.array([-10.0, -10.0, -5.0, -5.0]),
            np.array([10.0, 10.0, 5.0, 5.0]))
    res4 = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                             jnp.asarray(u_ref), jnp.asarray(hs_h),
                             jnp.asarray(hs_g), position_bounds=full)
    res2 = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                             jnp.asarray(u_ref), jnp.asarray(hs_h),
                             jnp.asarray(hs_g),
                             position_bounds=(full[0][:2], full[1][:2]))
    np.testing.assert_allclose(np.asarray(res4.u_filtered),
                               np.asarray(res2.u_filtered), atol=1e-12)


def test_fallback_replays_shifted_last_u():
    """Force non-convergence (one IPM iteration and an unreachable
    tolerance: the active-set polish alone can reach the optimum from
    one iteration) and verify the fallback shifts the previous optimal
    sequence (reference core/mpc_filter.py:195-207)."""
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=6)
    rng = np.random.default_rng(0)
    last_u = rng.normal(size=(H, 2))
    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g),
                            last_optimal_u=jnp.asarray(last_u),
                            has_last=True, max_iters=1, tol=0.0)
    assert bool(res.used_fallback)
    expected = np.concatenate([last_u[1:], u_ref[H - 1:H]], axis=0)
    np.testing.assert_allclose(np.asarray(res.u_filtered), expected,
                               atol=1e-12)
    # fallback trajectory re-simulated through the dynamics
    x = np.asarray(res.x_filtered)
    A_np, B_np = np.asarray(A), np.asarray(B)
    for t in range(H):
        np.testing.assert_allclose(x[t + 1],
                                   A_np @ x[t] + B_np @ expected[t],
                                   atol=1e-10)


def test_fallback_without_history_uses_u_ref():
    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(seed=7)
    u_ref = np.random.default_rng(1).normal(size=(H, 2))
    res = filter_trajectory(prob, jnp.asarray(x0), jnp.asarray(x_ref),
                            jnp.asarray(u_ref), jnp.asarray(hs_h),
                            jnp.asarray(hs_g), max_iters=1, tol=0.0)
    assert bool(res.used_fallback)
    np.testing.assert_allclose(np.asarray(res.u_filtered), u_ref, atol=1e-12)


def test_filter_core_batched_matches_flat_vmap():
    """Chunked batching (per-chunk while_loops, VERDICT r3 weak #4) is a
    scheduling change only: results must match the flat vmap solve."""
    import jax

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.mpc_filter import (
        _filter_core, filter_core_batched)

    prob, A, B, C, x0, x_ref, u_ref, hs_h, hs_g = _setup(n_obs=1, seed=3)
    rng = np.random.default_rng(9)
    B_total, chunk = 6, 2
    x0_b = jnp.asarray(x0[None] + 0.05 * rng.normal(size=(B_total, 4)))
    xr_b = jnp.asarray(np.broadcast_to(x_ref, (B_total,) + x_ref.shape))
    hh_b = jnp.asarray(np.broadcast_to(hs_h, (B_total,) + hs_h.shape))
    hg_b = jnp.asarray(rng.uniform(-1.0, 0.5, size=(B_total,) + hs_g.shape))
    u_min = jnp.asarray([-5.0, -5.0])
    u_max = -u_min
    p_min = jnp.asarray([-10.0, -10.0])
    p_max = -p_min

    u_c, s_c, sol_c, obj_c = filter_core_batched(
        prob, x0_b, xr_b, hh_b, hg_b, u_min, u_max, p_min, p_max,
        40, None, chunk=chunk)
    u_f, s_f, sol_f, obj_f = jax.vmap(
        lambda a, b, c, d: _filter_core(prob, a, b, c, d, u_min, u_max,
                                        p_min, p_max, 40, None)
    )(x0_b, xr_b, hh_b, hg_b)
    assert np.asarray(sol_c.converged).all()
    np.testing.assert_allclose(np.asarray(u_c), np.asarray(u_f),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(obj_c), np.asarray(obj_f),
                               rtol=1e-7, atol=1e-8)
    # B <= chunk passes through the flat path.
    u_1, _, _, _ = filter_core_batched(
        prob, x0_b[:2], xr_b[:2], hh_b[:2], hg_b[:2], u_min, u_max,
        p_min, p_max, 40, None, chunk=4)
    np.testing.assert_allclose(np.asarray(u_1), np.asarray(u_f[:2]),
                               rtol=1e-7, atol=1e-8)
    # Non-multiple batches work: lax.map's batch_size handles the
    # remainder chunk natively.
    u_r, _, _, _ = filter_core_batched(
        prob, x0_b[:5], xr_b[:5], hh_b[:5], hg_b[:5], u_min, u_max,
        p_min, p_max, 40, None, chunk=2)
    np.testing.assert_allclose(np.asarray(u_r), np.asarray(u_f[:5]),
                               rtol=1e-7, atol=1e-8)


def test_box_theta_structured_matches_dense():
    """The [I; -I; Theta; -Theta] structured G_u operators must produce
    the same solution as the dense products (same QP, same tolerances;
    only the FLOP count differs)."""
    import jax.numpy as jnp
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
        solve_mpc_qp)

    rng = np.random.default_rng(11)
    n, hp, m2 = 8, 6, 5
    L = rng.normal(size=(n, n))
    P_uu = jnp.asarray(L @ L.T + np.eye(n))
    q_u = jnp.asarray(rng.normal(size=n))
    T = rng.normal(size=(hp, n))
    G_u = jnp.asarray(np.vstack([np.eye(n), -np.eye(n), T, -T]))
    h1 = jnp.asarray(rng.uniform(0.5, 2.0, size=2 * n + 2 * hp))
    A = jnp.asarray(rng.normal(size=(m2, n)))
    b = jnp.asarray(rng.uniform(-1.0, 1.0, size=m2))

    dense = solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, 100.0, 50.0)
    struct = solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, 100.0, 50.0,
                          box_theta=jnp.asarray(T))
    assert bool(dense.converged) and bool(struct.converged)
    np.testing.assert_allclose(np.asarray(struct.u), np.asarray(dense.u),
                               rtol=1e-6, atol=1e-7)
    assert float(struct.obj) == pytest.approx(float(dense.obj), abs=1e-7)
