"""Smoke run of the DR-CVaR safety filter on NVIDIA GPUs, in one process.

    python chip_smoke.py          # phases 1-5 on one card
    python chip_smoke.py --four   # only the four-card mesh phase

Phases, in order; any failure ends the run with a non-zero exit code:

  1. device   -- JAX must find a GPU (no CPU fallback); prints the
                 nvidia-smi name and power limit, device kind, JAX version
                 and the compile-cache directory;
  2. single   -- the CLI (`--mode single`) on all four scenarios under both
                 presets, then the numerical contract on the card: controls
                 within 1e-4 of the float64 scipy QP oracle (tests/oracle.py)
                 solved on the card's own halfspaces, and the card's
                 CVaR / DR-CVaR offsets against the LP oracles;
  3. evaluator scale -- 256 vmapped multi_obstacle scenarios at N=1000,
                 the CLI's 300-run Monte Carlo, and 8 scenarios compared
                 with the same program on the host CPU backend;
  4. kernels  -- the Triton halfspace kernel at N=1000/B=32768 and
                 N=4096/B=8192 against the XLA closed form on the card and
                 a NumPy float64 sort-based CVaR;
  5. timings  -- kernel vs XLA closed form (alone and inside the
                 256-scenario pipeline step), and the share of device time
                 the MPC QP spends factorising and solving (profiler trace).

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Artifacts (plots, Monte Carlo arrays, the trace) go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SCENARIOS = ("head_on", "overtaking", "intersection", "multi_obstacle")
PRESETS = ("custom", "paper")

U_ORACLE_TOL = 1e-4      # BASELINE.md north star, float64 oracle vs card
# Halfspace offsets: f32 rounding of O(10) world coordinates is ~1e-6;
# 2e-5 is the repo's CPU golden bound for the fused kernel.
G_TOL = 2e-5
# GPU vs host CPU, float32 both: the same QP solved to the same merit
# tolerance, differing only in f32 summation order and in the halfspace
# path (Triton kernel vs XLA closed form, ~1e-6 in the QP data), which
# the QP's conditioning amplifies to at most ~1e-3.
CROSS_BACKEND_TOL = 5e-3

PIPE_BATCH, PIPE_N = 256, 1000          # evaluator batch (bench.py shape)
CROSS_BATCH = 8
MC_RUNS = 300
KERNEL_SHAPES = ((1000, 32768), (4096, 8192))   # (N, B)
ORACLE_ROWS = 64
MPC_BATCH, MPC_OBS = 2048, 3
REPEATS = 7


def check(ok, message):
    """Fail the run (never carry on) when `ok` is false."""
    if not ok:
        raise RuntimeError(message)


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX (run before JAX touches the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices, count=None):
    """Refuse any backend but the GPU: this script measures the card."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); nothing to check")
    if count is not None and len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devices)}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def median_time(fn, *args, repeats=REPEATS):
    """Median wall seconds of fn(*args) to completion, warm-up excluded."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------- phase 2

def _oracle_matrices(dt):
    import numpy as np

    A = np.eye(4)
    A[0, 2] = A[1, 3] = dt
    B = np.zeros((4, 2))
    B[0, 0] = B[1, 1] = 0.5 * dt ** 2
    B[2, 0] = B[3, 1] = dt
    C = np.zeros((2, 4))
    C[0, 0] = C[1, 1] = 1.0
    return A, B, C


def phase_single(out_dir):
    import jax.numpy as jnp
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.cli import (
        main as cli_main)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        INPUT_BOUNDS, METRICS, STATE_BOUNDS, make_statics,
        run_scenario_with_obstacles)
    from oracle import cvar_halfspace_lp, dr_cvar_halfspace_lp
    from test_reference_parity import reference_rng_obstacles

    for preset in PRESETS:
        for name in SCENARIOS:
            res = cli_main(["--scenario", name, "--mode", "single",
                            "--preset", preset, "--dtype", "float32",
                            "--save_dir", os.path.join(out_dir, preset)])
            check(bool(np.all(np.isfinite(np.asarray(res.filtered_u)))),
                  f"CLI {preset}/{name}: non-finite controls")

    print(f"oracle check: max|u_gpu - u_oracle| < {U_ORACLE_TOL:g} "
          f"(float64 scipy trust-constr on the card's halfspaces); "
          f"|g_gpu - g_lp| < {G_TOL:g} (scipy linprog)", flush=True)
    jobs, rows = [], []
    for preset in PRESETS:
        params = get_parameters(preset)
        A, B, C = _oracle_matrices(params.dt)
        for name in SCENARIOS:
            scenario = get_scenario_config(name, preset)
            sim_time = scenario.sim_time or params.sim_time
            obstacles = reference_rng_obstacles(
                scenario, sim_time, params.dt, params.num_samples)
            statics = make_statics(scenario, params, jnp.float32)
            res = run_scenario_with_obstacles(
                statics, obstacles, jnp.asarray(scenario.ego_start),
                jnp.asarray(scenario.ego_goal), params.ego_velocity)
            check(bool(np.asarray(res.qp_converged).all()),
                  f"{preset}/{name}: QP did not converge on the card")
            x0 = np.zeros(4)
            x0[:2] = scenario.ego_start
            samples = np.asarray(obstacles.samples, np.float64)
            r_comb = params.robot_radius + params.obstacle_radius
            for mi, metric in enumerate(METRICS):
                hs = res.halfspaces.by_metric(metric)
                h = np.asarray(hs.h, np.float64)
                g = np.asarray(hs.g_tilde, np.float64)
                # Steps past the obstacle data get the pipeline's inactive
                # padding rows (models/pipeline.py): unit normal, g=-1e4.
                pad = params.horizon - h.shape[0]
                h_full = np.concatenate(
                    [h, np.tile([1.0, 0.0], (pad, h.shape[1], 1))])
                g_full = np.concatenate([g, np.full((pad, g.shape[1]),
                                                    -1e4)])
                jobs.append((A, B, C, params.q_weight, params.r_weight,
                             params.horizon, x0,
                             np.asarray(res.x_ref, np.float64), h_full,
                             g_full, INPUT_BOUNDS[0], INPUT_BOUNDS[1],
                             STATE_BOUNDS[0][:2], STATE_BOUNDS[1][:2]))
                dev_g = 0.0
                if metric != "mean":
                    for t in range(h.shape[0]):
                        for j in range(h.shape[1]):
                            s = samples[j, :, t, :] @ h[t, j]
                            r_t = r_comb * np.linalg.norm(h[t, j])
                            if metric == "cvar":
                                lp = cvar_halfspace_lp(
                                    s, params.alpha, params.delta, r_t)
                            else:
                                lp = dr_cvar_halfspace_lp(
                                    s, params.alpha, params.delta,
                                    params.epsilon, r_t) - r_t
                            dev_g = max(dev_g, abs(g[t, j] - lp))
                rows.append((preset, name, metric,
                             np.asarray(res.filtered_u[mi], np.float64),
                             dev_g))
    # The scipy oracles run in worker processes that never import JAX:
    # only this process touches the card.
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), mp_context=ctx,
            initializer=_one_blas_thread) as ex:
        oracle_u = [u for u, _, _ in ex.map(mpc_qp_oracle_star, jobs)]
    worst_u, worst_g = 0.0, 0.0
    for (preset, name, metric, u_gpu, dev_g), u_oracle in zip(rows,
                                                              oracle_u):
        dev_u = float(np.max(np.abs(u_gpu - u_oracle)))
        worst_u, worst_g = max(worst_u, dev_u), max(worst_g, dev_g)
        print(f"  {preset:6s} {name:14s} {metric:7s} "
              f"max|du| = {dev_u:.3e} (tol {U_ORACLE_TOL:g})  "
              f"max|dg| = {dev_g:.3e} (tol {G_TOL:g})", flush=True)
    for (preset, name, metric, u_gpu, dev_g), u_oracle in zip(rows,
                                                              oracle_u):
        dev_u = float(np.max(np.abs(u_gpu - u_oracle)))
        check(dev_u < U_ORACLE_TOL,
              f"{preset}/{name}/{metric}: control deviation "
              f"{dev_u:.3e} >= {U_ORACLE_TOL:g}")
        check(dev_g < G_TOL,
              f"{preset}/{name}/{metric}: offset deviation "
              f"{dev_g:.3e} >= {G_TOL:g}")
    print(f"phase 2 OK: 4 scenarios x 2 presets x 3 metrics, worst "
          f"|du| {worst_u:.3e}, worst |dg| {worst_g:.3e}", flush=True)


def _one_blas_thread():
    """Worker start-up, before NumPy loads: one BLAS thread per worker,
    so the workers do not oversubscribe the host's cores."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def mpc_qp_oracle_star(args):
    """tests/oracle.py's float64 MPC QP oracle on one argument tuple (a
    module-level function, so a worker process can unpickle it)."""
    from oracle import mpc_qp_oracle

    return mpc_qp_oracle(*args)


# ---------------------------------------------------------------- phase 3

def _pipeline_setup(preset="custom"):
    """The evaluator batch of bench.py: multi_obstacle, N=1000, 6 s."""
    import dataclasses

    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        make_statics)

    params = dataclasses.replace(get_parameters(preset),
                                 num_samples=PIPE_N, sim_time=6.0)
    scenario = get_scenario_config("multi_obstacle", preset=preset)
    return params, scenario, make_statics(scenario, params, jnp.float32)


def _pipeline_batch_fn(statics, params, scenario):
    import jax
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        run_scenario_core)

    n_steps = int(params.sim_time / params.dt)
    consts = [jnp.asarray(v, jnp.float32) for v in (
        scenario.ego_goal, scenario.obstacle_starts,
        scenario.obstacle_directions, scenario.obstacle_speeds)]

    @jax.jit
    def batch(keys, ego_starts):
        def one(key, ego_s):
            res = run_scenario_core(
                statics, key, ego_s, *consts, n_steps, PIPE_N,
                params.noise_var, params.ego_velocity, qp_iters=35,
                qp_tol=3e-5)
            return res.filtered_u, res.distances, res.qp_converged
        return jax.vmap(one)(keys, ego_starts)

    return batch


def _host_obstacles(scenario, params, n_batch, seed):
    """[n_batch] obstacle sets drawn on the host (NumPy), so two backends
    see bit-identical inputs."""
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.obstacles import (
        ObstacleData)

    rng = np.random.default_rng(seed)
    n_steps = int(params.sim_time / params.dt)
    starts = np.asarray(scenario.obstacle_starts)
    dirs = np.asarray(scenario.obstacle_directions)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    speeds = np.asarray(scenario.obstacle_speeds)
    t = np.arange(n_steps + 1)[None, :, None] * params.dt
    nominal = starts[:, None] + t * (speeds[:, None, None] * dirs[:, None])
    std = np.sqrt(params.noise_var)
    noise = std * rng.normal(size=(n_batch, len(starts), PIPE_N,
                                   n_steps + 1, 2))
    noise[..., 0, :] = 0.0
    real = std * rng.laplace(size=(n_batch,) + nominal.shape)
    real[..., 0, :] = 0.0
    f32 = np.float32
    return ObstacleData(
        nominal=np.broadcast_to(nominal, (n_batch,) + nominal.shape)
        .astype(f32),
        samples=(nominal[None, :, None] + noise).astype(f32),
        realization=(nominal[None] + real).astype(f32))


def phase_scale(out_dir):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.cli import (
        main as cli_main)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.models.pipeline import (
        run_scenario_with_obstacles)

    params, scenario, statics = _pipeline_setup()
    batch = _pipeline_batch_fn(statics, params, scenario)
    keys = jax.random.split(jax.random.PRNGKey(0), PIPE_BATCH)
    ego = jnp.broadcast_to(jnp.asarray(scenario.ego_start, jnp.float32),
                           (PIPE_BATCH, 2))
    compiled = batch.lower(keys, ego).compile()
    print(f"pipeline batch {PIPE_BATCH} x multi_obstacle N={PIPE_N} "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    u, dist, conv = compiled(keys, ego)
    u, dist, conv = (np.asarray(x) for x in (u, dist, conv))
    check(u.shape == (PIPE_BATCH, 3, params.horizon, 2),
          f"pipeline batch: u shape {u.shape}")
    check(np.isfinite(u).all() and np.isfinite(dist).all(),
          "pipeline batch: non-finite output")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"pipeline batch OK: {conv.mean():.4f} of QPs converged, "
          f"peak_bytes_in_use {peak}", flush=True)

    mc = cli_main(["--scenario", "head_on", "--mode", "monte_carlo",
                   "--mc_runs", str(MC_RUNS), "--save_dir",
                   os.path.join(out_dir, "monte_carlo")])
    md = np.asarray(mc.min_distances)
    check(md.shape == (MC_RUNS, 4) and np.isfinite(md).all(),
          f"Monte Carlo: min distances {md.shape}, finite "
          f"{np.isfinite(md).all()}")
    print(f"Monte Carlo {MC_RUNS} runs OK", flush=True)

    # GPU vs host CPU on identical host-generated obstacles.
    obs = _host_obstacles(scenario, params, CROSS_BATCH, seed=1)
    ego_s = jnp.asarray(scenario.ego_start, jnp.float32)
    goal = jnp.asarray(scenario.ego_goal, jnp.float32)

    def run(device):
        with jax.default_device(device):
            out = jax.vmap(lambda o: run_scenario_with_obstacles(
                statics, o, ego_s, goal, params.ego_velocity, 35, 3e-5))(
                    jax.tree_util.tree_map(jnp.asarray, obs))
            return (np.asarray(out.filtered_u), np.asarray(out.distances),
                    np.asarray(out.qp_converged))

    u_g, d_g, c_g = run(jax.devices()[0])
    u_c, d_c, c_c = run(jax.devices("cpu")[0])
    du = float(np.abs(u_g - u_c).max())
    dd = float(np.abs(d_g - d_c).max())
    print(f"GPU vs CPU f32, {CROSS_BATCH} scenarios: max|du| = {du:.3e}, "
          f"max|d dist| = {dd:.3e} (tol {CROSS_BACKEND_TOL:g}); converged "
          f"gpu {c_g.mean():.3f} cpu {c_c.mean():.3f}", flush=True)
    check(bool((c_g == c_c).all()), "GPU and CPU convergence differ")
    check(du < CROSS_BACKEND_TOL and dd < CROSS_BACKEND_TOL,
          "GPU vs CPU deviation above tolerance")
    print("phase 3 OK", flush=True)
    return params, scenario, batch, keys, ego


# ---------------------------------------------------------------- phase 4

def _kernel_data(n, b, seed):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def make(key):
        k1, k2 = jax.random.split(key)
        s = (jnp.array([0.5, 0.0], jnp.float32)
             + 0.1 * jax.random.normal(k1, (b, n, 2), jnp.float32))
        e = 0.1 * jax.random.normal(k2, (b, 2), jnp.float32)
        return s, e

    return make(jax.random.PRNGKey(seed))


def _xla_metrics(params):
    """The XLA closed forms for all three metrics (the CPU path)."""
    import jax

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        cvar_halfspace, dr_cvar_halfspace, mean_halfspace)

    p = params

    @jax.jit
    def xla(s, e):
        m = mean_halfspace(s, p.robot_radius, p.obstacle_radius)
        c = cvar_halfspace(s, e, p.alpha, p.delta, p.robot_radius,
                           p.obstacle_radius)
        d = dr_cvar_halfspace(s, e, p.alpha, p.delta, p.epsilon,
                              p.robot_radius, p.obstacle_radius)
        return m.h, m.g_tilde, c.h, c.g_tilde, d.g_tilde

    return xla


def _kernel_fn(params, rows=None, num_warps=None):
    import jax

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        fused_metric_halfspaces)

    p = params
    return jax.jit(lambda s, e: fused_metric_halfspaces(
        s, e, p.alpha, p.delta, p.epsilon, p.robot_radius,
        p.obstacle_radius, rows=rows, num_warps=num_warps))


def _numpy_cvar_offsets(s, e, p):
    """float64, sort-based: (h [R,2], g_cvar [R], g_drcvar [R])."""
    import math

    import numpy as np

    n = s.shape[1]
    diff = (s - e[:, None]).mean(axis=1)
    h = diff / np.linalg.norm(diff, axis=-1, keepdims=True)
    x = -np.einsum("rnd,rd->rn", s, h)
    an = p.alpha * n
    k = max(min(math.ceil(an - 1e-12), n), 1)
    v = -np.sort(-x, axis=1)[:, k - 1]
    gt = x > v[:, None]
    cvar = (np.where(gt, x, 0.0).sum(1) + (an - gt.sum(1)) * v) / an
    r = p.robot_radius + p.obstacle_radius
    return h, cvar + r - p.delta, cvar - p.delta + p.epsilon / p.alpha


def phase_kernels():
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters)

    p = get_parameters("custom")
    kernel, xla = _kernel_fn(p), _xla_metrics(p)
    names = ("h_mean", "g_mean", "h", "g_cvar", "g_drcvar")
    print(f"kernel check: float32 Triton kernel vs XLA closed form (f32, "
          f"same card) and vs NumPy float64 sort on {ORACLE_ROWS} rows; "
          f"tol {G_TOL:g} absolute", flush=True)
    for n, b in KERNEL_SHAPES:
        s, e = _kernel_data(n, b, seed=n)
        got = [np.asarray(o) for o in kernel(s, e)]
        want = [np.asarray(o) for o in xla(s, e)]
        devs = {k: float(np.abs(g - w).max())
                for k, g, w in zip(names, got, want)}
        rows = np.linspace(0, b - 1, ORACLE_ROWS).astype(int)
        h64, gc64, gd64 = _numpy_cvar_offsets(
            np.asarray(s, np.float64)[rows], np.asarray(e, np.float64)[rows],
            p)
        devs["h_vs_f64"] = float(np.abs(got[2][rows] - h64).max())
        devs["g_cvar_vs_f64"] = float(np.abs(got[3][rows] - gc64).max())
        devs["g_drcvar_vs_f64"] = float(np.abs(got[4][rows] - gd64).max())
        print(f"  N={n} B={b}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in devs.items()), flush=True)
        worst = max(devs.values())
        check(worst < G_TOL, f"kernel N={n}: deviation {worst:.3e}")
    print("phase 4 OK", flush=True)


# ---------------------------------------------------------------- phase 5

# Launch shapes tried at each width; launch_config's choice is among them.
LAUNCH_SWEEP = {1000: ((1, 4), (2, 4), (4, 4), (4, 8), (8, 8)),
                4096: ((1, 4), (1, 8), (1, 16), (2, 8))}


def phase_timings(card, out_dir, pipe):
    import unittest.mock

    import jax
    import jax.numpy as jnp

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.environment as env_mod
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        launch_config)

    tag = f"[{card}]"
    p = get_parameters("custom")
    xla = _xla_metrics(p)
    print(f"timings: median of {REPEATS} block_until_ready calls after "
          "warm-up", flush=True)
    for n, b in KERNEL_SHAPES:
        s, e = _kernel_data(n, b, seed=n)
        t_xla = median_time(xla, s, e)
        print(f"  halfspace N={n} B={b}: XLA closed form "
              f"{t_xla * 1e3:.4f} ms {tag}", flush=True)
        for rows, warps in LAUNCH_SWEEP[n]:
            t_k = median_time(_kernel_fn(p, rows, warps), s, e)
            chosen = " (launch_config)" if (rows, warps) == launch_config(
                n) else ""
            print(f"  halfspace N={n} B={b}: kernel rows={rows} "
                  f"warps={warps} {t_k * 1e3:.4f} ms, {t_xla / t_k:.2f}x "
                  f"XLA{chosen} {tag}", flush=True)
        del s, e

    params, scenario, batch, keys, ego = pipe
    t_pk = median_time(batch, keys, ego)
    # Fresh statics retrace the pipeline with the kernel gate off.
    with unittest.mock.patch.object(env_mod, "_use_kernel",
                                    lambda env, n: False):
        _, _, statics_x = _pipeline_setup()
        t_px = median_time(_pipeline_batch_fn(statics_x, params, scenario),
                           keys, ego)
    print(f"  pipeline step {PIPE_BATCH} x multi_obstacle N={PIPE_N}: "
          f"kernel {t_pk * 1e3:.4f} ms, XLA closed form "
          f"{t_px * 1e3:.4f} ms {tag}", flush=True)

    ipm_share(tag, out_dir)
    print("phase 5 OK", flush=True)


def _mpc_data(prob, batch, n_obs, horizon):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    x0 = 0.1 * jax.random.normal(ks[0], (batch, 4), jnp.float32)
    x_ref = jnp.cumsum(0.2 * jax.random.normal(
        ks[1], (batch, horizon + 1, 4), jnp.float32), axis=1)
    hs_h = jax.random.normal(ks[2], (batch, horizon, n_obs, 2), jnp.float32)
    hs_h = hs_h / jnp.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = jax.random.uniform(ks[3], (batch, horizon, n_obs), jnp.float32,
                              -1.5, 0.2)
    return x0, x_ref, hs_h, hs_g


def ipm_share(tag, out_dir):
    """Share of device time in the IPM's Cholesky factorisations and
    triangular solves (named scopes ipm_factor / ipm_solve), MPC QP at
    H=30, n_obs=3, B=2048, read from a profiler trace."""
    import glob
    import re

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
                             MPC_OBS)
    data = _mpc_data(prob, MPC_BATCH, MPC_OBS, p.horizon)
    bounds = [jnp.asarray(v, jnp.float32) for v in
              ([-5.0, -5.0], [5.0, 5.0], [-10.0, -10.0], [10.0, 10.0])]

    def solve(*d):
        return filter_core_batched(prob, *d, *bounds, 35, 3e-5)[0]

    solve = jax.jit(solve).lower(*data).compile()
    t = median_time(solve, *data)
    print(f"  MPC QP H={p.horizon} n_obs={MPC_OBS} B={MPC_BATCH}: "
          f"{t * 1e3:.4f} ms per batch {tag}", flush=True)
    # HLO instruction -> op_name metadata, which carries the named scopes.
    scopes = dict(re.findall(r'%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"',
                             solve.as_text()))
    trace_dir = os.path.join(out_dir, "mpc_trace")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(solve(*data))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    totals = device_kernel_times(path, scopes, DEVICE_PLANE)
    check(totals, "profiler trace holds no device events")
    lin = re.compile(r"ipm_factor|ipm_solve|potrf|trsm|cholesky|"
                     r"triangular|cusolver", re.I)
    busy = sum(v for v, _ in totals.values())
    in_lin = sum(v for v, text in totals.values() if lin.search(text))
    print(f"  MPC QP device time {busy / 1e6:.4f} ms in trace; "
          f"factorisation + triangular solves {in_lin / 1e6:.4f} ms = "
          f"{100.0 * in_lin / busy:.1f}% {tag}", flush=True)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ns, text) in top:
        mark = "*" if lin.search(text) else " "
        print(f"    {mark} {ns / 1e6:9.4f} ms  {text[:100]}", flush=True)


DEVICE_PLANE = "/device:GPU"


def device_kernel_times(path, scopes, plane_prefix):
    """{event name: (total ns, name + HLO op + its op_name)} over the
    trace planes whose name starts with `plane_prefix`."""
    from jax.profiler import ProfileData

    totals = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                hlo_op = dict(ev.stats).get("hlo_op")
                if hlo_op is None:
                    continue
                text = f"{ev.name} {hlo_op} {scopes.get(hlo_op, '')}"
                ns, _ = totals.get(ev.name, (0.0, text))
                totals[ev.name] = (ns + ev.duration_ns, text)
    return totals


# ---------------------------------------------------------- four cards

def phase_four(devices):
    """Monte Carlo over a 4-card data mesh and the sample-sharded DR-CVaR
    select over 4 cards, each against the same work on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.config import (
        get_parameters, get_scenario_config)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation import (
        run_monte_carlo_simulation)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_g_star)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel import (
        dr_cvar_g_sample_parallel, make_mesh)

    params = get_parameters("custom")
    scenario = get_scenario_config("head_on")
    mesh = make_mesh(n_data=4, devices=devices[:4])
    sharded = run_monte_carlo_simulation(scenario, params, n_runs=MC_RUNS,
                                         seed=42, mesh=mesh)
    with jax.default_device(devices[0]):
        single = run_monte_carlo_simulation(scenario, params,
                                            n_runs=MC_RUNS, seed=42)
    md4 = np.asarray(sharded.min_distances)
    md1 = np.asarray(single.min_distances)
    dev = float(np.abs(md4 - md1).max())
    same_conv = bool((np.asarray(sharded.qp_converged)
                      == np.asarray(single.qp_converged)).all())
    print(f"Monte Carlo head_on {MC_RUNS} runs, data=4 mesh vs one card: "
          f"max|d min distance| = {dev:.3e} (tol {CROSS_BACKEND_TOL:g}), "
          f"convergence identical {same_conv}", flush=True)
    check(md4.shape == (MC_RUNS, 4) and same_conv
          and dev < CROSS_BACKEND_TOL, "four-card Monte Carlo mismatch")

    n, b = 4096, 1024
    s, e = _kernel_data(n, b, seed=4)
    diff = (s - e[:, None]).mean(axis=1)
    h = diff / jnp.linalg.norm(diff, axis=-1, keepdims=True)
    sp_mesh = make_mesh(n_data=1, n_samples=4, devices=devices[:4])
    g_sp = np.asarray(dr_cvar_g_sample_parallel(
        sp_mesh, s, h, params.alpha, params.delta, params.epsilon,
        params.robot_radius, params.obstacle_radius))
    with jax.default_device(devices[0]):
        g_1, _ = dr_cvar_g_star(s, h, params.alpha, params.delta,
                                params.epsilon, params.robot_radius,
                                params.obstacle_radius)
    dg = float(np.abs(g_sp - np.asarray(g_1)).max())
    print(f"sample-parallel DR-CVaR N={n} B={b}, samples=4 vs one card: "
          f"max|dg| = {dg:.3e} (tol {G_TOL:g})", flush=True)
    check(dg < G_TOL, "sample-parallel DR-CVaR mismatch")

    for d in devices[:4]:
        stats = d.memory_stats() or {}
        print(f"  {d}: bytes_in_use {stats.get('bytes_in_use')}, "
              f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
              flush=True)
        check(stats.get("peak_bytes_in_use", 0) > 0, f"{d} did no work")
    print("four-card phase OK", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)

    smi = nvidia_smi()                      # before JAX opens the card
    import jax

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils import (
        enable_compile_cache)

    cache = enable_compile_cache()
    devices = jax.devices()
    require_gpu(devices, 4 if args.four else None)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    os.makedirs(OUT_DIR, exist_ok=True)
    print(smi, flush=True)
    card = " / ".join(smi.splitlines()[:1])
    print(f"device_kind {devices[0].device_kind}, {len(devices)} device(s), "
          f"jax {jax.__version__}, compile cache {cache}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        phase_four(devices)
        devices = devices[:4]
    else:
        phase_single(OUT_DIR)
        print(f"[{time.perf_counter() - t0:.1f} s elapsed]", flush=True)
        pipe = phase_scale(OUT_DIR)
        print(f"[{time.perf_counter() - t0:.1f} s elapsed]", flush=True)
        phase_kernels()
        print(f"[{time.perf_counter() - t0:.1f} s elapsed]", flush=True)
        phase_timings(card, OUT_DIR, pipe)
        print(f"[{time.perf_counter() - t0:.1f} s elapsed]", flush=True)
        devices = devices[:1]
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
