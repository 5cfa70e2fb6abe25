"""CLI driver for the DR-CVaR safety-filtering engine.

Installed as the `dr-cvar-filter` console script; `python main.py` at
the repo root is a shim onto this module.

Same command surface as the reference (reference main.py:193-236):

  python main.py --scenario head_on --mode single [--animate]
                 [--metric dr_cvar]
  python main.py --mode timing_analysis --sample_sizes 10,50,... \
                 --timing_runs 50
plus new modes/flags:
  --mode monte_carlo --mc_runs 300     (restored ghost module)
  --preset custom|paper                (replaces comment-toggled configs)
  --dtype float32|float64
  --mesh data=N[,samples=M]            (shard monte_carlo / timing
                                        sweeps over a device mesh;
                                        multi-host coordinator env vars
                                        trigger jax.distributed init)
Artifacts are written under --save_dir (default `results/`) with the same
file names the reference produces (main.py:156-173,249-261).  Plots need
matplotlib (the `plots` extra); without it the computation still runs
and one line says the plots were skipped.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np


def _parse_mesh_spec(spec: str) -> dict:
    """Parse `data=N[,samples=M]` into axis sizes."""
    axes = {"data": None, "samples": 1}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        name = name.strip()
        if (name not in axes or not value.strip().isdigit()
                or int(value) < 1):
            raise SystemExit(
                f"--mesh: bad axis spec '{part}' "
                "(expected data=N[,samples=M], sizes >= 1)")
        axes[name] = int(value)
    if axes["data"] is None:
        raise SystemExit("--mesh: a data=N axis is required")
    return axes


def _can_plot() -> bool:
    """Whether matplotlib is installed; says on one line when it is not
    and the plots are skipped."""
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: skipped plots "
              "(pip install '.[plots]')")
        return False
    return True


def _plotting():
    """simulation.visualization, or None when matplotlib is missing."""
    if not _can_plot():
        return None
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
        visualization)
    return visualization


def build_mesh(args):
    """Build the device mesh requested by --mesh (None if absent).

    When multi-host coordinator environment variables are present the
    jax.distributed runtime is initialized first, so the same flag works
    on a multi-host cluster (parallel/distributed.py).
    """
    if not getattr(args, "mesh", None):
        return None
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel.distributed import (  # noqa: E501
        initialize_distributed)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel.mesh import (  # noqa: E501
        make_mesh)

    if any(v in os.environ for v in ("JAX_COORDINATOR_ADDRESS",
                                     "COORDINATOR_ADDRESS",
                                     "JAX_COORDINATOR_IP")):
        initialize_distributed()
    axes = _parse_mesh_spec(args.mesh)
    import jax
    n_need = axes["data"] * axes["samples"]
    n_have = len(jax.devices())
    if n_need > n_have:
        raise SystemExit(
            f"--mesh {args.mesh}: needs {n_need} devices, "
            f"{n_have} visible (for CPU testing set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N "
            "JAX_PLATFORMS=cpu)")
    return make_mesh(n_data=axes["data"], n_samples=axes["samples"])


def run_single(args):
    import jax.numpy as jnp

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32

    print(f"Running scenario: {scenario.description}")
    with dct.utils.Timer("Full pipeline (jit + run)"):
        result = dct.models.run_single_scenario(scenario, params,
                                                seed=args.seed, dtype=dtype)

    # In-memory counterpart of the reference's per-solve timing side
    # channel (reference core/risk_metrics.py:16-33): solver iteration /
    # gap / wall-time info rides in the result struct itself.
    print("\nMPC Feasibility Information:")
    for i, metric in enumerate(dct.models.METRICS):
        status = "optimal" if bool(result.qp_converged[i]) else "fallback"
        print(f"{metric} status: {status}  "
              f"(ipm_iters={int(result.qp_iterations[i])}, "
              f"gap={float(result.qp_gap[i]):.2e})")
    print(f"pipeline wall time: {float(result.wall_time_ms):.1f} ms "
          f"(jit + all 3 metrics)")

    distances = {m: np.asarray(result.distances[i])
                 for i, m in enumerate(dct.models.METRICS)}
    distances["reference"] = np.asarray(result.reference_distance)
    for name, d in distances.items():
        verdict = "COLLISION" if d.min() < 0 else "Safe"
        print(f"{name:10s}: min distance {d.min():+.4f}  [{verdict}]")

    viz = _plotting()
    if viz is None:
        return result
    os.makedirs(args.save_dir, exist_ok=True)
    viz.plot_distance_to_collision(
        distances,
        save_path=os.path.join(args.save_dir,
                               f"{args.scenario}_results.png"))

    metric = args.metric
    idx = dct.models.METRICS.index(metric)
    hs = result.halfspaces.by_metric(metric)
    viz.visualize_trajectory_with_halfspaces(
        np.asarray(result.filtered_x[idx]),
        np.asarray(result.obstacles.realization),
        np.asarray(hs.h), np.asarray(hs.g_tilde),
        params.robot_radius, params.obstacle_radius,
        title=(f"{args.scenario.capitalize()} Scenario with "
               f"{metric.upper()} Safe Halfspaces"),
        save_path=os.path.join(
            args.save_dir, f"{args.scenario}_{metric}_halfspaces.png"))
    print(f"Saved plots to {args.save_dir}/")

    if args.animate:
        print("\nCreating animation...")
        path = os.path.join(args.save_dir,
                            f"{args.scenario}_{metric}_animation.mp4")
        viz.animate_scenario(
            np.asarray(result.filtered_x[idx]),
            np.asarray(result.obstacles.realization),
            params.robot_radius, params.obstacle_radius,
            np.asarray(hs.h), np.asarray(hs.g_tilde),
            title=(f"{args.scenario.capitalize()} Scenario with "
                   f"{metric.upper()} Safety Filtering"),
            save_path=path)
        print(f"Animation saved near {path}")
    return result


def run_timing(args):
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu as dct

    params = dct.config.get_parameters(args.preset)
    sizes = [int(n.strip()) for n in args.sample_sizes.split(",")]
    mesh = build_mesh(args)
    if mesh is not None:
        print(f"Sharding the timing sweep over mesh {dict(mesh.shape)}")
    _can_plot()
    print("\nRunning DR-CVaR computation time analysis...")
    dct.evaluation.analyze_dr_cvar_computation_time(
        sample_sizes=sizes, n_runs=args.timing_runs,
        save_dir=args.save_dir, params=params, mesh=mesh)
    print(f"Timing analysis complete. Results saved to {args.save_dir}")


def run_monte_carlo(args):
    import jax.numpy as jnp

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu as dct

    params = dct.config.get_parameters(args.preset)
    scenario = dct.config.get_scenario_config(args.scenario, args.preset)
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    mesh = build_mesh(args)
    if mesh is not None:
        print(f"Sharding the MC run axis over mesh {dict(mesh.shape)}")
    print(f"Monte Carlo: {args.mc_runs} runs of {args.scenario} ...")
    with dct.utils.Timer("Monte Carlo (jit + run)"):
        result = dct.evaluation.run_monte_carlo_simulation(
            scenario, params, n_runs=args.mc_runs, seed=args.seed,
            dtype=dtype, mesh=mesh)
    dct.evaluation.print_mc_summary(result)

    os.makedirs(args.save_dir, exist_ok=True)
    npz_path = os.path.join(args.save_dir, f"{args.scenario}_mc_data.npz")
    dct.evaluation.save_mc_result(result, npz_path)
    print(f"Saved MC arrays to {npz_path}")
    viz = _plotting()
    if viz is None:
        return result
    names = list(dct.models.METRICS) + ["reference"]
    md = np.asarray(result.min_distances)
    viz.compare_risk_metrics(
        {name: md[:, i] for i, name in enumerate(names)},
        save_path=os.path.join(args.save_dir,
                               f"{args.scenario}_mc_comparison.png"),
        title=f"{args.scenario}: min distance over {args.mc_runs} MC runs")
    print(f"Saved MC comparison plot to {args.save_dir}/")
    return result


def main(argv=None):
    """Parse `argv` and run one mode; returns the ScenarioResult
    (single) or MonteCarloResult (monte_carlo), None for the sweep."""
    parser = argparse.ArgumentParser(
        description="Run DR-CVaR Safety Filtering Scenarios")
    parser.add_argument("--scenario",
                        choices=["head_on", "overtaking", "intersection",
                                 "multi_obstacle"],
                        default="head_on")
    parser.add_argument("--mode",
                        choices=["single", "timing_analysis", "monte_carlo"],
                        default="single")
    parser.add_argument("--animate", action="store_true")
    parser.add_argument("--metric", choices=["mean", "cvar", "dr_cvar"],
                        default="dr_cvar")
    parser.add_argument("--sample_sizes", type=str,
                        default="10,50,100,500,1000,1500")
    parser.add_argument("--timing_runs", type=int, default=50)
    parser.add_argument("--mc_runs", type=int, default=300)
    parser.add_argument("--preset", choices=["custom", "paper"],
                        default="custom")
    parser.add_argument("--dtype", choices=["float32", "float64"],
                        default="float32")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--mesh", type=str, default=None,
                        help="shard monte_carlo / timing_analysis over a "
                             "device mesh, e.g. data=8 or "
                             "data=4,samples=2 (single mode ignores it)")
    parser.add_argument("--save_dir", type=str, default="results")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a jax.profiler device trace of the "
                             "run into this directory (TensorBoard/xprof)")
    args = parser.parse_args(argv)

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils import (
        enable_compile_cache, trace)

    enable_compile_cache()
    os.makedirs(args.save_dir, exist_ok=True)
    result = None
    with trace(args.profile_dir):
        if args.mode == "single":
            if args.mesh:
                print("--mesh is ignored in --mode single "
                      "(one scenario; use monte_carlo/timing_analysis)")
            result = run_single(args)
        elif args.mode == "timing_analysis":
            run_timing(args)
        elif args.mode == "monte_carlo":
            result = run_monte_carlo(args)
    if args.profile_dir:
        print(f"Profiler trace written to {args.profile_dir}")
    return result


if __name__ == "__main__":
    main()
