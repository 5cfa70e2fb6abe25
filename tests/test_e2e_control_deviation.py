"""North-star accuracy test: end-to-end control deviation < 1e-4.

BASELINE.md's north star demands max control deviation < 1e-4 vs the
reference optimum for the full H=30 pipeline.  This test runs the
complete engine pipeline (reference-RNG-replayed seed-42 obstacle
streams -> planner -> halfspaces -> MPC filter) on `head_on` and
`multi_obstacle`, solves the IDENTICAL QP with the independent scipy
`trust-constr` oracle (tests/oracle.py) at H=30, and asserts

    max |u_engine - u_oracle| < 1e-4

in BOTH float64 and float32 (the accelerator default).  The float32 bound is
met by the active-set Newton polish in ops/qp_ipm_structured.py
(_polish): without it the float32 IPM merit floor leaves deviations up
to ~1e-2 on multi_obstacle.

Reference contract: core/mpc_filter.py:40-178, main.py:19-186.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
    Parameters, get_scenario_config)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
    METRICS, make_statics, run_scenario_with_obstacles)

from oracle import mpc_qp_oracle
from test_reference_parity import reference_rng_obstacles

SCENARIOS = ("head_on", "multi_obstacle")


@pytest.fixture(scope="module")
def e2e_runs():
    """Engine runs (f64 + f32) and oracle solutions per scenario."""
    params = Parameters()
    A = np.eye(4)
    A[0, 2] = A[1, 3] = params.dt
    B = np.zeros((4, 2))
    B[0, 0] = B[1, 1] = 0.5 * params.dt ** 2
    B[2, 0] = B[3, 1] = params.dt
    C = np.zeros((2, 4))
    C[0, 0] = C[1, 1] = 1.0
    u_min = np.array([-5.0, -5.0])
    p_min = np.array([-10.0, -10.0])

    out = {}
    for name in SCENARIOS:
        scenario = get_scenario_config(name)
        obstacles = reference_rng_obstacles(
            scenario, params.sim_time, params.dt, params.num_samples)

        runs = {}
        for dtype in (jnp.float64, jnp.float32):
            statics = make_statics(scenario, params, dtype)
            runs[dtype] = run_scenario_with_obstacles(
                statics, obstacles,
                jnp.asarray(scenario.ego_start),
                jnp.asarray(scenario.ego_goal),
                params.ego_velocity)

        res64 = runs[jnp.float64]
        x0 = np.zeros(4)
        x0[:2] = scenario.ego_start
        oracles = {}
        for mi, metric in enumerate(METRICS):
            hs = res64.halfspaces.by_metric(metric)
            u_oracle, _, _ = mpc_qp_oracle(
                A, B, C, params.q_weight, params.r_weight, params.horizon,
                x0, np.asarray(res64.x_ref),
                np.asarray(hs.h), np.asarray(hs.g_tilde),
                u_min, -u_min, p_min, -p_min)
            oracles[metric] = u_oracle
        out[name] = (runs, oracles)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("metric", METRICS)
def test_control_deviation_f64(e2e_runs, scenario, metric):
    runs, oracles = e2e_runs[scenario]
    res = runs[jnp.float64]
    mi = METRICS.index(metric)
    assert bool(res.qp_converged[mi])
    dev = np.max(np.abs(np.asarray(res.filtered_u[mi], np.float64)
                        - oracles[metric]))
    assert dev < 1e-6, f"f64 deviation {dev:.3e}"


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("metric", METRICS)
def test_control_deviation_f32(e2e_runs, scenario, metric):
    """The north-star bound at the accelerator's float32 precision."""
    runs, oracles = e2e_runs[scenario]
    res = runs[jnp.float32]
    mi = METRICS.index(metric)
    assert bool(res.qp_converged[mi])
    dev = np.max(np.abs(np.asarray(res.filtered_u[mi], np.float64)
                        - oracles[metric]))
    assert dev < 1e-4, f"f32 deviation {dev:.3e}"
