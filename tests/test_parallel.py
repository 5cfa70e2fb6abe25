"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
    Parameters, get_scenario_config)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
    make_statics)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
    dr_cvar_g_star)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel import (
    dr_cvar_g_sample_parallel, make_mesh, run_batch_sharded,
    sharded_halfspace_throughput)

ALPHA, DELTA, EPS, RR, RO = 0.2, 0.1, 0.15, 0.3, 0.3


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sample_parallel_matches_closed_form():
    """psum-based distributed DR-CVaR == single-device closed form."""
    mesh = make_mesh(n_data=2, n_samples=4)
    rng = np.random.default_rng(0)
    samples = jnp.asarray(rng.normal(size=(6, 64, 2)))
    h = rng.normal(size=(6, 2))
    h = jnp.asarray(h / np.linalg.norm(h, axis=-1, keepdims=True))
    g_sp = dr_cvar_g_sample_parallel(mesh, samples, h, ALPHA, DELTA, EPS,
                                     RR, RO)
    g_ref, _ = dr_cvar_g_star(samples, h, ALPHA, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(np.asarray(g_sp), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_sp", [1, 2, 8])
def test_sample_parallel_mesh_shapes(n_sp):
    mesh = make_mesh(n_data=8 // n_sp, n_samples=n_sp)
    rng = np.random.default_rng(1)
    samples = jnp.asarray(rng.normal(size=(4, 8 * n_sp, 2)))
    h = rng.normal(size=(4, 2))
    h = jnp.asarray(h / np.linalg.norm(h, axis=-1, keepdims=True))
    g_sp = dr_cvar_g_sample_parallel(mesh, samples, h, ALPHA, DELTA, EPS,
                                     RR, RO)
    g_ref, _ = dr_cvar_g_star(samples, h, ALPHA, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(np.asarray(g_sp), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


def test_sample_parallel_data_sharded_batch():
    """Multi-host mesh form: instances sharded over 'data' (hosts) AND
    samples over 'samples' (devices of one host) -- the multi-host layout of
    parallel/distributed.py, emulated on the virtual mesh."""
    from jax.sharding import PartitionSpec as P
    mesh = make_mesh(n_data=2, n_samples=4)
    rng = np.random.default_rng(3)
    samples = jnp.asarray(rng.normal(size=(6, 64, 2)))
    h = rng.normal(size=(6, 2))
    h = jnp.asarray(h / np.linalg.norm(h, axis=-1, keepdims=True))
    g_sp = dr_cvar_g_sample_parallel(mesh, samples, h, ALPHA, DELTA, EPS,
                                     RR, RO,
                                     batch_axis_spec=P("data", "samples",
                                                       None))
    g_ref, _ = dr_cvar_g_star(samples, h, ALPHA, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(np.asarray(g_sp), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


def test_data_sharded_halfspace_matches_single_device():
    mesh = make_mesh(n_data=8, n_samples=1)
    rng = np.random.default_rng(2)
    samples = jnp.asarray(rng.normal(size=(16, 32, 2)))
    h = rng.normal(size=(16, 2))
    h = jnp.asarray(h / np.linalg.norm(h, axis=-1, keepdims=True))
    g = sharded_halfspace_throughput(mesh, samples, h, ALPHA, DELTA, EPS,
                                     RR, RO)
    g_ref, _ = dr_cvar_g_star(samples, h, ALPHA, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-6)


def test_run_batch_sharded_pipeline():
    """Full pipeline batch sharded over 8 devices executes and returns
    per-run results identical to an unsharded vmap."""
    params = Parameters(horizon=6, sim_time=2.0, num_samples=8)
    scenario = get_scenario_config("head_on")
    statics = make_statics(scenario, params, jnp.float64)
    n_steps = int(params.sim_time / params.dt)
    mesh = make_mesh(n_data=8, n_samples=1)
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    min_d, ref_min, conv = run_batch_sharded(mesh, statics, keys, scenario,
                                             params, n_steps)
    assert min_d.shape == (16, 3)
    assert ref_min.shape == (16,)

    # Unsharded comparison.
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        run_scenario_core)
    res0 = run_scenario_core(
        statics, keys[0], jnp.asarray(scenario.ego_start),
        jnp.asarray(scenario.ego_goal),
        jnp.asarray(scenario.obstacle_starts),
        jnp.asarray(scenario.obstacle_directions),
        jnp.asarray(scenario.obstacle_speeds),
        n_steps, params.num_samples, params.noise_var, params.ego_velocity)
    np.testing.assert_allclose(np.asarray(min_d[0]),
                               np.asarray(res0.distances.min(axis=1)),
                               rtol=1e-10)


def test_mc_mesh_and_nonmesh_agree():
    """run_monte_carlo_simulation must produce the same statistics with
    and without a mesh (round-4 review: the two paths solved with
    different qp_iters, silently diverging).  Key-prefix property makes
    the padded mesh key batch share its first n_runs keys with the
    non-mesh split, so results must agree to float32 reduction noise."""
    import numpy as np
    from jax.sharding import Mesh

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu as dct
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.monte_carlo import (
        run_monte_carlo_simulation)

    params = dct.config.get_parameters("custom")
    import dataclasses
    params = dataclasses.replace(params, sim_time=4.0, num_samples=10)
    scenario = dct.config.get_scenario_config("head_on")

    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("data",))
    r_plain = run_monte_carlo_simulation(scenario, params, n_runs=10,
                                         seed=3, dtype=jnp.float32)
    r_mesh = run_monte_carlo_simulation(scenario, params, n_runs=10,
                                        seed=3, dtype=jnp.float32,
                                        mesh=mesh)
    # 5e-5: shard_map and vmap compile to different fusion orders, so
    # f32 reductions differ in the last bits; the bug this guards
    # against (different qp_iters -> fallback flips) shifts distances
    # by ~0.1.
    np.testing.assert_allclose(np.asarray(r_mesh.min_distances),
                               np.asarray(r_plain.min_distances),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(np.asarray(r_mesh.qp_converged),
                                  np.asarray(r_plain.qp_converged))


def test_cli_mesh_monte_carlo(tmp_path):
    """`main.py --mode monte_carlo --mesh data=8` must produce the
    mesh-path results and agree with the meshless CLI run (VERDICT r4
    next #5: the distributed layer must be reachable from the CLI)."""
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu import (
        cli)

    common = ["--mode", "monte_carlo", "--scenario", "head_on",
              "--preset", "paper", "--mc_runs", "6", "--seed", "3"]
    cli.main(common + ["--save_dir", str(tmp_path / "plain")])
    cli.main(common + ["--mesh", "data=8",
                       "--save_dir", str(tmp_path / "mesh")])

    with np.load(tmp_path / "plain" / "head_on_mc_data.npz") as plain, \
            np.load(tmp_path / "mesh" / "head_on_mc_data.npz") as mesh:
        # Same seed => same key prefix on both paths; tolerance covers
        # shard_map-vs-vmap f32 fusion-order noise only (see
        # test_mc_mesh_and_nonmesh_agree).
        np.testing.assert_allclose(mesh["min_distances"],
                                   plain["min_distances"],
                                   rtol=5e-5, atol=5e-5)


def test_cli_mesh_timing_analysis(tmp_path):
    """`--mode timing_analysis --mesh data=8` routes the sweep through
    the sharded solvers and writes the same artifact set."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu import (
        cli)

    cli.main(["--mode", "timing_analysis", "--mesh", "data=8",
              "--sample_sizes", "10,20", "--timing_runs", "4",
              "--save_dir", str(tmp_path)])
    assert (tmp_path / "timing_comparison.csv").exists()
    assert (tmp_path / "timing_data.txt").exists()


def test_sharded_timing_solvers_match_plain():
    """Mesh-sharded sweep solvers == the plain batched solvers,
    including a batch NOT divisible by the data axis (pad + strip)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.timing_analysis import (
        _make_batched_solvers)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel.sweep import (
        make_sharded_timing_solvers)

    params = Parameters()
    mesh = make_mesh(n_data=8)
    dr_s, cv_s = make_sharded_timing_solvers(mesh, params)
    dr_p, cv_p = _make_batched_solvers(params)

    rng = np.random.default_rng(7)
    h = jnp.asarray(np.array([1.0, 1.0]) / np.sqrt(2.0))
    # B=11 (pad < B) and B=3 (pad EXCEEDS B: the wrap-fill must repeat
    # rows, a plain samples[:pad] slice under-fills -- round-5 review).
    for B in (11, 3):
        samples = jnp.asarray(np.array([0.5, 0.0])
                              + 0.1 * rng.normal(size=(B, 40, 2)))
        np.testing.assert_allclose(np.asarray(dr_s(samples, h)),
                                   np.asarray(dr_p(samples, h)),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(cv_s(samples, h)),
                                   np.asarray(cv_p(samples, h)),
                                   rtol=1e-6, atol=1e-8)
