"""Golden tests: closed-form halfspace offsets vs independent LP oracles.

The engine replaces the reference's ECOS-solved CVaR / DR-CVaR
programs (reference core/risk_metrics.py:84-265) with closed forms; these
tests prove the closed forms equal the programs' optima by solving the
ORIGINAL programs with scipy.linprog (an independent solver and code
path) on randomized instances.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.geometry import (
    compute_separating_vector)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
    cvar_g_star, cvar_halfspace, dr_cvar_g_star, dr_cvar_halfspace,
    mean_halfspace)
from oracle import cvar_halfspace_lp, dr_cvar_halfspace_lp

ALPHA, DELTA, EPSILON = 0.2, 0.1, 0.15
RR, RO = 0.3, 0.3


def _random_instance(seed, n):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-2, 2, size=2)
    samples = mean + 0.1 * rng.normal(size=(n, 2))
    ego = rng.uniform(-3, 3, size=2)
    h = np.asarray(compute_separating_vector(jnp.asarray(ego),
                                             jnp.asarray(samples.mean(0))))
    return samples, ego, h


@pytest.mark.parametrize("n", [10, 20, 100])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cvar_g_star_vs_lp(n, seed):
    samples, _, h = _random_instance(seed, n)
    s = samples @ h
    r_tilde = (RR + RO) * np.linalg.norm(h)
    ours = float(cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                             ALPHA, DELTA, RR, RO))
    lp = cvar_halfspace_lp(s, ALPHA, DELTA, r_tilde)
    assert ours == pytest.approx(lp, abs=1e-7)


@pytest.mark.parametrize("n", [10, 20, 100])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_dr_cvar_g_star_vs_lp(n, seed):
    samples, _, h = _random_instance(seed, n)
    s = samples @ h
    r_tilde = (RR + RO) * np.linalg.norm(h)
    g_star, g_tilde = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                                     ALPHA, DELTA, EPSILON, RR, RO)
    lp = dr_cvar_halfspace_lp(s, ALPHA, DELTA, EPSILON, r_tilde)
    assert float(g_star) == pytest.approx(lp, abs=1e-7)
    assert float(g_tilde) == pytest.approx(lp - r_tilde, abs=1e-7)


@pytest.mark.parametrize("alpha,delta,epsilon", [
    (0.1, 0.1, 0.15), (0.2, 0.05, 0.3), (0.33, 0.2, 0.05)])
def test_dr_cvar_parameter_sweep(alpha, delta, epsilon):
    """Unlike the reference's singleton cache (keyed only on n_samples,
    core/risk_metrics.py:289), the closed form responds to every
    parameter change; verify against the LP at several settings."""
    samples, _, h = _random_instance(11, 40)
    s = samples @ h
    r_tilde = (RR + RO) * np.linalg.norm(h)
    g_star, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                               alpha, delta, epsilon, RR, RO)
    lp = dr_cvar_halfspace_lp(s, alpha, delta, epsilon, r_tilde)
    assert float(g_star) == pytest.approx(lp, abs=1e-7)


def test_drcvar_equals_cvar_plus_epsilon_over_alpha():
    """Structural identity g*_drcvar = g*_cvar + eps/alpha."""
    samples, _, h = _random_instance(21, 30)
    g_c = float(cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                            ALPHA, DELTA, RR, RO))
    g_d, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                            ALPHA, DELTA, EPSILON, RR, RO)
    assert float(g_d) == pytest.approx(g_c + EPSILON / ALPHA, abs=1e-9)


def test_drcvar_monotone_in_epsilon():
    """g*(epsilon) is increasing; at epsilon=0 it equals the CVaR level
    (SURVEY.md section 4 suggested property)."""
    samples, _, h = _random_instance(31, 25)
    g0, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                           ALPHA, DELTA, 0.0, RR, RO)
    g1, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                           ALPHA, DELTA, 0.1, RR, RO)
    g2, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                           ALPHA, DELTA, 0.2, RR, RO)
    g_c = float(cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                            ALPHA, DELTA, RR, RO))
    assert float(g0) == pytest.approx(g_c, abs=1e-9)
    assert float(g0) < float(g1) < float(g2)


def test_mean_halfspace_analytic():
    """Mean halfspace: h from ORIGIN to sample mean (reference quirk,
    core/halfspaces.py:88), g~ = -(h.mu - r||h||) (core/halfspaces.py:94)."""
    rng = np.random.default_rng(5)
    samples = np.array([1.5, -0.5]) + 0.05 * rng.normal(size=(20, 2))
    hs = mean_halfspace(jnp.asarray(samples), RR, RO)
    mu = samples.mean(0)
    h_exp = mu / np.linalg.norm(mu)
    np.testing.assert_allclose(np.asarray(hs.h), h_exp, atol=1e-12)
    g_exp = -(h_exp @ mu - (RR + RO))
    assert float(hs.g_tilde) == pytest.approx(g_exp, abs=1e-12)


def test_offset_conventions():
    """CVaR halfspace keeps g* as offset; DR-CVaR subtracts r~
    (reference core/halfspaces.py:131 vs core/risk_metrics.py:297)."""
    samples, ego, h = _random_instance(41, 20)
    cv = cvar_halfspace(jnp.asarray(samples), jnp.asarray(ego),
                        ALPHA, DELTA, RR, RO)
    dr = dr_cvar_halfspace(jnp.asarray(samples), jnp.asarray(ego),
                           ALPHA, DELTA, EPSILON, RR, RO)
    g_c = float(cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                            ALPHA, DELTA, RR, RO))
    g_d, g_d_tilde = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                                    ALPHA, DELTA, EPSILON, RR, RO)
    assert float(cv.g_tilde) == pytest.approx(g_c, abs=1e-9)
    assert float(dr.g_tilde) == pytest.approx(float(g_d_tilde), abs=1e-9)
    np.testing.assert_allclose(np.asarray(cv.h), h, atol=1e-12)


def test_batched_halfspaces_match_loop():
    """Batched (t, obstacle) halfspace evaluation equals per-instance."""
    rng = np.random.default_rng(6)
    samples = rng.normal(size=(5, 3, 20, 2))  # [t, obs, N, 2]
    ego = rng.normal(size=(5, 1, 2))
    batched = dr_cvar_halfspace(jnp.asarray(samples), jnp.asarray(ego),
                                ALPHA, DELTA, EPSILON, RR, RO)
    for t in range(5):
        for j in range(3):
            single = dr_cvar_halfspace(jnp.asarray(samples[t, j]),
                                       jnp.asarray(ego[t, 0]),
                                       ALPHA, DELTA, EPSILON, RR, RO)
            np.testing.assert_allclose(np.asarray(batched.h[t, j]),
                                       np.asarray(single.h), atol=1e-12)
            assert float(batched.g_tilde[t, j]) == pytest.approx(
                float(single.g_tilde), abs=1e-9)
