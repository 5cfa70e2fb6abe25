"""Worker body for the 2-process fake-cluster test (multi-host path).

Launched by tests/test_distributed.py as
`python tests/distributed_worker.py <process_id> <num_processes> <port>`.
Each process fakes one "host" of 4 CPU devices; jax.distributed wires
them into one 8-device cluster with Gloo cross-host collectives.  This
exercises the real multi-host code path (jax.distributed.initialize,
process-boundary-aware mesh, cross-process collectives) that a multi-host
GPU cluster uses, minus only the NVLink/network fabric itself.
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")

    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel import (
        dr_cvar_g_sample_parallel, initialize_distributed,
        make_multihost_mesh, to_global_array)

    assert initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert len(jax.local_devices()) == 4
    assert len(jax.devices()) == nproc * 4

    mesh = make_multihost_mesh()
    assert mesh.devices.shape == (nproc, 4)
    # Host boundaries: each data-row must be exactly one process's
    # devices, so sample-axis collectives never cross hosts.
    for i, row in enumerate(mesh.devices):
        assert all(d.process_index == i for d in row), (
            f"row {i} spans processes "
            f"{[d.process_index for d in row]}")

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_g_star)

    ALPHA, DELTA, EPS, RR, RO = 0.2, 0.1, 0.15, 0.3, 0.3
    rng = np.random.default_rng(7)
    samples = np.asarray(rng.normal(size=(6, 64, 2)), np.float32)
    h = np.asarray(rng.normal(size=(6, 2)), np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    g_ref, _ = dr_cvar_g_star(jnp.asarray(samples), jnp.asarray(h),
                              ALPHA, DELTA, EPS, RR, RO)
    g_ref = np.asarray(g_ref)

    # 1) sample axis over each host's local devices + data over hosts
    #    (the N-sample psum reductions stay intra-host).
    g_sp = dr_cvar_g_sample_parallel(
        mesh, jnp.asarray(samples), jnp.asarray(h),
        ALPHA, DELTA, EPS, RR, RO,
        batch_axis_spec=P("data", "samples", None))
    # g_sp is data-sharded (not fully addressable here); gather it
    # replicated before reading -- the cross-host metric gather.
    g_sp = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(g_sp)
    np.testing.assert_allclose(np.asarray(g_sp), g_ref, rtol=2e-5,
                               atol=2e-5)
    print(f"proc {pid}: sample-parallel over multi-host mesh OK", flush=True)

    # 2) instance batch sharded over the FULL mesh (cross-host dp).
    sharding = NamedSharding(mesh, P(("data", "samples")))

    def solve(samples, h):
        g, _ = dr_cvar_g_star(samples, h, ALPHA, DELTA, EPS, RR, RO)
        return g

    solve_sharded = jax.jit(
        solve, in_shardings=(sharding, sharding),
        out_shardings=NamedSharding(mesh, P()))
    big = np.asarray(rng.normal(size=(16, 64, 2)), np.float32)
    hb = np.asarray(rng.normal(size=(16, 2)), np.float32)
    hb /= np.linalg.norm(hb, axis=-1, keepdims=True)
    g_dp = solve_sharded(to_global_array(big, sharding),
                         to_global_array(hb, sharding))
    g_dp_ref, _ = dr_cvar_g_star(jnp.asarray(big), jnp.asarray(hb),
                                 ALPHA, DELTA, EPS, RR, RO)
    np.testing.assert_allclose(np.asarray(g_dp), np.asarray(g_dp_ref),
                               rtol=2e-5, atol=2e-5)
    print(f"proc {pid}: cross-host data-parallel batch OK", flush=True)

    # 3) full pipeline batch over the data (host) axis, metric
    #    aggregation pulled back replicated (the cross-host gather).
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        Parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        make_statics, run_scenario_core)

    params = Parameters(horizon=4, sim_time=2.0, num_samples=8)
    scenario = get_scenario_config("head_on")
    statics = make_statics(scenario, params, jnp.float32)
    n_steps = int(params.sim_time / params.dt)
    args = (jnp.asarray(scenario.ego_start), jnp.asarray(scenario.ego_goal),
            jnp.asarray(scenario.obstacle_starts),
            jnp.asarray(scenario.obstacle_directions),
            jnp.asarray(scenario.obstacle_speeds))

    def one(key):
        res = run_scenario_core(statics, key, *args, n_steps,
                                params.num_samples, params.noise_var,
                                params.ego_velocity, qp_iters=8)
        return res.distances.min(axis=1)

    keys = jax.random.split(jax.random.PRNGKey(0), nproc * 4)
    keys_g = to_global_array(np.asarray(keys),
                             NamedSharding(mesh, P(("data", "samples"))))
    pipe = jax.jit(jax.vmap(one),
                   in_shardings=NamedSharding(mesh, P(("data", "samples"))),
                   out_shardings=NamedSharding(mesh, P()))
    min_d = pipe(keys_g)
    assert min_d.shape == (nproc * 4, 3)
    min_d_ref = jax.jit(jax.vmap(one))(keys)   # local, unsharded
    np.testing.assert_allclose(np.asarray(min_d), np.asarray(min_d_ref),
                               rtol=1e-5, atol=1e-5)
    print(f"proc {pid}: cross-host pipeline batch OK", flush=True)


if __name__ == "__main__":
    main()
