"""Benchmark: DR-CVaR halfspace + MPC throughput on one NVIDIA GPU.

Prints a context line (card name and power limit from nvidia-smi), then
ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Headline metric: DR-CVaR safe-halfspace full-call solves/s at N=1000
samples -- the quantity the reference benchmarks serially at 69.011 ms
per call (14.49 calls/s) with CVXPY+ECOS on the author's CPU
(reference results/Timing_Analysis/timing_comparison.csv row N=1000;
BASELINE.md).

Measurement method
------------------
  1. K repetitions run INSIDE one XLA program via `lax.fori_loop`, with
     each iteration's inputs perturbed by the previous iteration's
     outputs (a data dependence: XLA can neither elide, hoist, nor
     reorder the iterations);
  2. the host times the call to completion with `block_until_ready`,
     after a warm-up call, and keeps the median of the repeats; the
     per-iteration time is that median over K;
  3. a sanity gate: where the per-iteration working set is larger than
     the card's 50 MB L2 cache it must stream from device memory, and
     the bench REFUSES to print a number whose implied compulsory
     bandwidth exceeds the card's peak.

The bench runs on a GPU only, and only on a card whose peak rates are in
`PEAKS`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_DRCVAR_CALL_S = 0.069011  # s per call, reference CSV N=1000
BASELINE_SOLVES_PER_S = 1.0 / BASELINE_DRCVAR_CALL_S

# Peak rates by JAX device_kind (NVIDIA H100 SXM data sheet: 3.35 TB/s
# HBM3, 67 TFLOP/s float32 outside the tensor cores).  A device that is
# not listed is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}
L2_BYTES = 50 * 1024 * 1024  # H100 L2 cache


def device_peaks(device_kind: str) -> dict:
    """Peak rates of `device_kind`; raises for a card not in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device_kind {device_kind!r}; add its "
            "data-sheet row to bench.PEAKS") from None


def _device():
    """(device_kind, peaks) of the GPU; refuses any other backend."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found platform "
                         f"{d.platform!r}")
    return d.device_kind, device_peaks(d.device_kind)


def _loop_time(loop_fn, k: int, repeats=5):
    """Per-iteration seconds of an in-program K-loop: the median over
    `repeats` of the call timed to completion, divided by k.

    loop_fn(k) must run k data-dependence-chained iterations inside one
    jitted program and return a scalar checksum.
    """
    import jax

    kk = jax.numpy.int32(k)
    jax.block_until_ready(loop_fn(kk))  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(loop_fn(kk))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / k


def _gate_bandwidth(name, compulsory_bytes_per_iter, per_iter_s,
                    working_set_bytes, peak_gbps):
    """Refuse numbers whose compulsory device-memory bandwidth beats the
    card.  Only a hard physical bound when the working set cannot stay
    in L2 across iterations; below that the implied figure is recorded
    but cannot be falsified."""
    implied = compulsory_bytes_per_iter / per_iter_s / 1e9
    hard = working_set_bytes > L2_BYTES
    if hard and implied > peak_gbps * 1.05:
        print(json.dumps({
            "metric": "MEASUREMENT_REJECTED",
            "bench": name,
            "implied_hbm_gbps": round(implied, 1),
            "peak_hbm_gbps": peak_gbps,
            "reason": "implied compulsory bandwidth exceeds the card's "
                      "peak; timing did not capture device execution",
        }))
        sys.exit(1)
    return implied, hard


def bench_halfspace(n_samples=1000, batch=32768, k_iters=64, seed=0):
    """Batched DR-CVaR + CVaR halfspace full calls (mean -> h -> project
    -> CVaR tail -> g), matching DRCVaRSafeHalfspace.create semantics,
    by the XLA closed form and by the fused Triton kernel (which
    computes all three metrics from one read of the samples).

    batch=32768 makes the sample tensor 256 MB (> L2), so every loop
    iteration must re-stream it from device memory and the bandwidth
    gate is a hard physical bound.
    """
    import jax
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        cvar_halfspace, dr_cvar_halfspace)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        fused_metric_halfspaces)

    p = get_parameters()
    device_kind, peaks = _device()
    peak_gbps = peaks["hbm_gbps"]

    def make_data(b, n, key):
        @jax.jit
        def make(key):
            k1, k2 = jax.random.split(key)
            s = (jnp.array([0.5, 0.0], jnp.float32)
                 + 0.1 * jax.random.normal(k1, (b, n, 2), jnp.float32))
            e = 0.1 * jax.random.normal(k2, (b, 2), jnp.float32)
            return s, e
        return jax.block_until_ready(make(key))

    samples, ego0 = make_data(batch, n_samples, jax.random.PRNGKey(seed))

    def make_loop(solver, s, e0):
        # Data enters as jit ARGUMENTS: a closed-over 256 MB device
        # array would lower as an embedded constant.
        @jax.jit
        def loop(k, s, e0):
            def body(i, carry):
                ego, acc = carry
                g = solver(s, ego)
                # Data dependence: next iteration's ego depends on this
                # iteration's solution (bounded 1e-6-scale drift).
                return e0 + 1e-6 * g[:, None], acc + jnp.sum(g)
            _, acc = jax.lax.fori_loop(
                0, k, body, (e0, jnp.float32(0.0)))
            return acc
        return lambda k: loop(k, s, e0)

    def dr_solver(s, e):
        return dr_cvar_halfspace(s, e, p.alpha, p.delta, p.epsilon,
                                 p.robot_radius, p.obstacle_radius).g_tilde

    def cv_solver(s, e):
        return cvar_halfspace(s, e, p.alpha, p.delta,
                              p.robot_radius, p.obstacle_radius).g_tilde

    def kernel_solver(s, e):
        return fused_metric_halfspaces(
            s, e, p.alpha, p.delta, p.epsilon, p.robot_radius,
            p.obstacle_radius)[4]

    sample_bytes = batch * n_samples * 2 * 4
    out = {}

    t_dr = _loop_time(make_loop(dr_solver, samples, ego0), k_iters)
    bw_dr, _ = _gate_bandwidth("drcvar_xla", sample_bytes, t_dr,
                               sample_bytes, peak_gbps)
    out["drcvar_xla_solves_per_s"] = batch / t_dr
    out["drcvar_xla_implied_hbm_gbps"] = bw_dr

    t_cv = _loop_time(make_loop(cv_solver, samples, ego0), k_iters)
    _gate_bandwidth("cvar_xla", sample_bytes, t_cv, sample_bytes, peak_gbps)
    out["cvar_solves_per_s"] = batch / t_cv

    t_pl = _loop_time(make_loop(kernel_solver, samples, ego0), k_iters)
    bw_pl, _ = _gate_bandwidth("drcvar_pallas", sample_bytes, t_pl,
                               sample_bytes, peak_gbps)
    out["drcvar_pallas_implied_hbm_gbps"] = bw_pl
    out["drcvar_pallas_solves_per_s"] = batch / t_pl

    # N=4096: the widest row the production path sends to the kernel.
    n_big, b_big = 4096, 8192
    big_bytes = b_big * n_big * 2 * 4  # 256 MB > L2: hard gate
    del samples
    samples_b, ego_b = make_data(b_big, n_big, jax.random.PRNGKey(seed + 1))
    t_pb = _loop_time(make_loop(kernel_solver, samples_b, ego_b), 16)
    _gate_bandwidth("drcvar_pallas_n4096", big_bytes, t_pb,
                    big_bytes, peak_gbps)
    out["drcvar_pallas_n4096_solves_per_s"] = b_big / t_pb
    t_xb = _loop_time(make_loop(dr_solver, samples_b, ego_b), 16)
    _gate_bandwidth("drcvar_xla_n4096", big_bytes, t_xb,
                    big_bytes, peak_gbps)
    out["drcvar_xla_n4096_solves_per_s"] = b_big / t_xb
    del samples_b, ego_b
    out["drcvar_solves_per_s"] = batch / min(t_dr, t_pl)

    # Batch-1 chained latency: the real-time-control number (per-solve
    # device latency; K chained solves in one program).
    s1, e1 = make_data(1, n_samples, jax.random.PRNGKey(seed))
    t_lat = _loop_time(make_loop(dr_solver, s1, e1), 512)
    out["drcvar_batch1_latency_us"] = t_lat * 1e6
    t_pl_lat = _loop_time(make_loop(kernel_solver, s1, e1), 512)
    out["drcvar_pallas_batch1_latency_us"] = t_pl_lat * 1e6
    out["device_kind"] = device_kind
    out["halfspace_batch"] = batch
    out["halfspace_k_iters"] = k_iters
    # Self-consistency: full-batch iteration must cost more than batch-1.
    if t_dr <= t_lat:
        print(json.dumps({"metric": "MEASUREMENT_REJECTED",
                          "bench": "halfspace_selfcheck",
                          "reason": "batch-32768 per-iter time <= batch-1"}))
        sys.exit(1)
    return out


# Conservative per-ITERATION / per-POLISH FLOP floors for the
# structured MPC QP (structured-G Schur assembly ~1.1 MFLOP + 60^3/3
# Cholesky + solves/matvecs ~ 1.2 MFLOP per Mehrotra iteration; the
# gathered active-set polish ~4 MFLOP).  The per-QP floor is DERIVED
# from the measured mean iteration count of the benched batch (the
# early exit retires it well before max_iters): measured iterations x
# per-iteration FLOPs.
MPC_FLOP_PER_ITER = 1.2e6
MPC_FLOP_POLISH = 4e6


def bench_mpc(batches=(512, 2048, 8192), k_iters=8, seed=0, n_obs=3):
    """Batched MPC interior-point solves at the reference stress shape:
    H=30, n_obs=3 (multi_obstacle -- 90 soft halfspace rows + boxes),
    swept over batch sizes to find the throughput knee.

    No hard bandwidth gate (the working set is small); honesty comes from
    the in-program chained loop, a conservative FLOP floor at the f32
    peak, and self-consistency with batch 1.
    """
    import jax
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.core.dynamics import (
        create_double_integrator_matrices)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.mpc_filter import (
        build_mpc_problem, filter_core_batched)

    p = get_parameters()
    A, B, C = create_double_integrator_matrices(p.dt, dtype=jnp.float32)
    prob = build_mpc_problem(A, B, C, p.q_weight, p.r_weight, p.horizon,
                             n_obs)
    H = p.horizon
    peak_tflops = _device()[1]["f32_tflops"]

    max_batch = max(batches)

    @jax.jit
    def make_data(key):
        ks = jax.random.split(key, 4)
        x0 = 0.1 * jax.random.normal(ks[0], (max_batch, 4), jnp.float32)
        x_ref = jnp.cumsum(
            0.2 * jax.random.normal(ks[1], (max_batch, H + 1, 4),
                                    jnp.float32), axis=1)
        hs_h = jax.random.normal(ks[2], (max_batch, H, n_obs, 2),
                                 jnp.float32)
        hs_h = hs_h / jnp.linalg.norm(hs_h, axis=-1, keepdims=True)
        hs_g = jax.random.uniform(ks[3], (max_batch, H, n_obs), jnp.float32,
                                  -1.5, 0.2)
        return x0, x_ref, hs_h, hs_g

    x0_0, x_ref, hs_h, hs_g = make_data(jax.random.PRNGKey(seed))
    jax.block_until_ready(x0_0)

    # Measured iteration count of this exact batch (untimed): the FLOP
    # floor and MFU are derived from it, not from max_iters.
    probe = filter_core_batched(
        prob, x0_0[:2048], x_ref[:2048], hs_h[:2048], hs_g[:2048],
        jnp.asarray([-5.0, -5.0], jnp.float32),
        jnp.asarray([5.0, 5.0], jnp.float32),
        jnp.asarray([-10.0, -10.0], jnp.float32),
        jnp.asarray([10.0, 10.0], jnp.float32), 35, 3e-5)[2]
    mean_iters = float(np.mean(np.asarray(probe.iterations)))
    flop_per_qp = mean_iters * MPC_FLOP_PER_ITER + MPC_FLOP_POLISH

    u_min = jnp.asarray([-5.0, -5.0], jnp.float32)
    u_max = -u_min
    p_min = jnp.asarray([-10.0, -10.0], jnp.float32)
    p_max = -p_min

    def solve(x0, x_ref, hs_h, hs_g):
        # Chunked batching: each 512-chunk gets its own IPM while_loop,
        # so large batches don't idle behind global stragglers (see
        # filter_core_batched).
        u, _, _, obj = filter_core_batched(prob, x0, x_ref, hs_h, hs_g,
                                           u_min, u_max, p_min, p_max,
                                           35, 3e-5)
        return u, obj

    @jax.jit
    def _mpc_loop(k, x0_init, xr, hh, hg):
        def body(i, carry):
            x0, acc = carry
            u, obj = solve(x0, xr, hh, hg)
            acc = acc + jnp.sum(obj)
            # next x0 depends on this iteration's solution
            x0 = x0_init + 1e-6 * u[:, 0, :].mean(-1, keepdims=True)
            return x0, acc
        _, acc = jax.lax.fori_loop(
            0, k, body, (x0_init, jnp.float32(0.0)))
        return acc

    def make_loop(x0_init, xr, hh, hg):
        # Problem data as jit arguments, not closure constants (see
        # bench_halfspace.make_loop).
        return lambda k: _mpc_loop(k, x0_init, xr, hh, hg)

    sweep = {}
    best_rate, best_batch = 0.0, batches[0]
    for batch in batches:
        # Fewer chained iterations at the largest batches: constant
        # total work, per-iteration time grows with batch.
        k = max(4, int(round(k_iters * batches[0] / batch)))
        t = _loop_time(
            make_loop(x0_0[:batch], x_ref[:batch], hs_h[:batch],
                      hs_g[:batch]), k)
        per_qp = t / batch
        # FLOP-floor gate at f32 peak, from the MEASURED mean iteration
        # count (see MPC_FLOP_PER_ITER note).
        if per_qp < flop_per_qp / (peak_tflops * 1e12):
            print(json.dumps({"metric": "MEASUREMENT_REJECTED",
                              "bench": "mpc",
                              "reason": f"{per_qp*1e6:.2f} us/QP beats the "
                                        "FLOP floor at f32 peak"}))
            sys.exit(1)
        rate = batch / t
        sweep[batch] = round(rate, 1)
        if rate > best_rate:
            best_rate, best_batch = rate, batch

    t1 = _loop_time(
        make_loop(x0_0[:1], x_ref[:1], hs_h[:1], hs_g[:1]), 64)
    mfu = best_rate * flop_per_qp / (peak_tflops * 1e12)
    return {"mpc_qp_solves_per_s": best_rate,
            "mpc_qp_best_batch": best_batch,
            "mpc_qp_batch_sweep": sweep,
            "mpc_qp_mfu_floor_pct": round(100.0 * mfu, 2),
            "mpc_qp_mean_ipm_iters": round(mean_iters, 1),
            "mpc_qp_n_obs": n_obs,
            "mpc_qp_batch1_latency_ms": t1 * 1e3}


def bench_pipeline(batch=256, n_samples=1000, k_iters=4, seed=0,
                   preset="custom"):
    """Full DR-CVaR scenario pipelines per second (multi-obstacle,
    N=1000 samples/obstacle: generation + planning + halfspaces under
    all 3 metrics + 3 vmapped MPC solves + distances).

    Run for both parameter presets (custom + paper) so the headline
    pipeline number covers the reference's two published configurations.
    """
    import jax
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        make_statics, run_scenario_core)

    import dataclasses

    base = get_parameters(preset)
    params = dataclasses.replace(base, num_samples=n_samples, sim_time=6.0)
    scenario = get_scenario_config("multi_obstacle", preset=preset)
    statics = make_statics(scenario, params, jnp.float32)
    n_steps = int(params.sim_time / params.dt)

    ego_start = jnp.asarray(scenario.ego_start, jnp.float32)
    ego_goal = jnp.asarray(scenario.ego_goal, jnp.float32)
    starts = jnp.asarray(scenario.obstacle_starts, jnp.float32)
    dirs = jnp.asarray(scenario.obstacle_directions, jnp.float32)
    speeds = jnp.asarray(scenario.obstacle_speeds, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)

    def one(key, ego_s):
        res = run_scenario_core(
            statics, key, ego_s, ego_goal, starts, dirs, speeds,
            n_steps, n_samples, params.noise_var, params.ego_velocity,
            qp_iters=35, qp_tol=3e-5)
        return res.distances.min(), res.filtered_u.sum()

    @jax.jit
    def loop(k):
        def body(i, carry):
            ego_b, acc = carry
            # fold the iteration index into the keys so obstacle
            # generation is not loop-invariant (cannot be hoisted)
            ks = jax.vmap(lambda kk: jax.random.fold_in(kk, i))(keys)
            dmin, usum = jax.vmap(one)(ks, ego_b)
            acc = acc + jnp.sum(dmin) + jnp.sum(usum)
            # data dependence across iterations
            ego_b = ego_start[None] + 1e-6 * dmin[:, None]
            return ego_b, acc
        ego_b0 = jnp.broadcast_to(ego_start, (batch, 2))
        _, acc = jax.lax.fori_loop(0, k, body,
                                   (ego_b0, jnp.float32(0.0)))
        return acc

    t = _loop_time(loop, k_iters)
    key = ("pipeline_scenarios_per_s" if preset == "custom"
           else f"pipeline_{preset}_scenarios_per_s")
    out = {key: batch / t}

    if preset == "custom":
        # Composed single-scenario latency (the paper's real-time-filter
        # use case): one full pipeline at batch 1, chained-loop method as
        # everywhere else.
        @jax.jit
        def lat_loop(k):
            def body(i, carry):
                ego, acc = carry
                kk = jax.random.fold_in(jax.random.PRNGKey(seed), i)
                dmin, usum = one(kk, ego)
                return ego_start + 1e-6 * dmin, acc + dmin + usum
            _, acc = jax.lax.fori_loop(
                0, k, body, (ego_start, jnp.float32(0.0)))
            return acc

        t1 = _loop_time(lat_loop, 256)
        out["pipeline_batch1_latency_ms"] = t1 * 1e3
    return out


def bench_mc(n_runs=300, k_iters=4, seed=0):
    """Monte-Carlo evaluation throughput: full MC runs per second
    (reference ghost module contract, SURVEY.md component 18 -- 300
    serial pipeline re-runs there; one vmapped program here).

    Same shape the CLI's `--mode monte_carlo --mc_runs 300` executes:
    head_on scenario, custom preset (N=20 samples, sim_time 30 s)."""
    import jax
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.monte_carlo import (
        _mc_core)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        make_statics)

    params = get_parameters("custom")
    scenario = get_scenario_config("head_on")
    statics = make_statics(scenario, params, jnp.float32)
    n_steps = int(params.sim_time / params.dt)
    args = (jnp.asarray(scenario.ego_start), jnp.asarray(scenario.ego_goal),
            jnp.asarray(scenario.obstacle_starts),
            jnp.asarray(scenario.obstacle_directions),
            jnp.asarray(scenario.obstacle_speeds))

    @jax.jit
    def loop(k):
        def body(i, acc):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            min_d, conv = _mc_core(
                statics, key, *args, n_runs, n_steps, params.num_samples,
                params.noise_var, params.ego_velocity)
            return acc + jnp.sum(min_d) + jnp.sum(conv)
        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    t = _loop_time(loop, k_iters)
    return {"mc_runs_per_s": n_runs / t, "mc_n_runs": n_runs}


def main():
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils import (
        enable_compile_cache)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    enable_compile_cache()
    _device()
    print(json.dumps({"metric": "bench_context", "card": card,
                      "method": "in-program lax.fori_loop K-chained "
                                "iterations, median of 5 calls timed "
                                "with block_until_ready, bandwidth gate "
                                "on >L2 working sets"}), flush=True)
    results = {}
    results.update(bench_halfspace())
    results.update(bench_mpc())
    results.update(bench_pipeline(preset="custom"))
    results.update(bench_pipeline(preset="paper"))
    results.update(bench_mc())

    value = results["drcvar_solves_per_s"]
    out = {
        "metric": "drcvar_halfspace_solves_per_s_n1000",
        "value": round(value, 2),
        "unit": "solves/s",
        "vs_baseline": round(value / BASELINE_SOLVES_PER_S, 2),
        "baseline_solves_per_s": round(BASELINE_SOLVES_PER_S, 2),
        "device_kind": results["device_kind"],
        "card": card,
        "halfspace_batch": results["halfspace_batch"],
        "mpc_qp_best_batch": results["mpc_qp_best_batch"],
        "mpc_qp_batch_sweep": results["mpc_qp_batch_sweep"],
        "mpc_qp_mfu_floor_pct": results["mpc_qp_mfu_floor_pct"],
        "mpc_qp_mean_ipm_iters": results["mpc_qp_mean_ipm_iters"],
        "mpc_qp_n_obs": results["mpc_qp_n_obs"],
        "mc_n_runs": results["mc_n_runs"],
    }
    for k in ("drcvar_xla_solves_per_s", "drcvar_xla_implied_hbm_gbps",
              "cvar_solves_per_s", "drcvar_batch1_latency_us",
              "drcvar_pallas_solves_per_s",
              "drcvar_pallas_implied_hbm_gbps",
              "drcvar_pallas_batch1_latency_us",
              "drcvar_pallas_n4096_solves_per_s",
              "drcvar_xla_n4096_solves_per_s", "mpc_qp_solves_per_s",
              "mpc_qp_batch1_latency_ms", "pipeline_scenarios_per_s",
              "pipeline_paper_scenarios_per_s",
              "pipeline_batch1_latency_ms", "mc_runs_per_s"):
        out[k] = results[k]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
