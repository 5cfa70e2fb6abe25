"""Timing benchmark for the CVaR / DR-CVaR halfspace solvers.

Counterpart of reference evaluation/timing_analysis.py:13-275.
The reference times ONE ECOS solve at a time in a Python loop (sizes x
runs x 2 programs) and splits setup/solve via a tmp-JSON side channel.
Here each (sample-size, run) cell is an instance of a BATCHED jitted
solve: all `n_runs` instances of a size execute in one device call, and
"setup" is the (amortized, in-memory) data-preparation cost -- no file
side channel (SURVEY.md section 1 quirk note).

Artifact parity: writes the same file names the reference produces --
`timing_comparison.csv` (same columns), `dr_cvar_computation_time.png`
and `dr_cvar_computation_time_with_outliers.png` (same 3-panel boxplot
layout, reference timing_analysis.py:134-225).  The plots need
matplotlib and are skipped without it.
"""

from __future__ import annotations

import csv
import importlib.util
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parameters
from ..ops.halfspace import cvar_g_star, dr_cvar_g_star
from ..utils.timing import Timer


def _make_batched_solvers(params: Parameters):
    """Jitted batched solvers: samples [B, N, 2], h [2] -> g values [B]."""

    @jax.jit
    def dr_batch(samples, h):
        g_star, g_tilde = dr_cvar_g_star(
            samples, h, params.alpha, params.delta, params.epsilon,
            params.robot_radius, params.obstacle_radius)
        return g_star

    @jax.jit
    def cvar_batch(samples, h):
        return cvar_g_star(samples, h, params.alpha, params.delta,
                           params.robot_radius, params.obstacle_radius)

    return dr_batch, cvar_batch


def save_timing_data(timing_data, path):
    """Persist the nested timing dict to an .npz checkpoint so long
    sweeps are resumable (SURVEY.md section 5, checkpoint/resume)."""
    flat = {}
    for key, by_n in timing_data.items():
        for n, values in by_n.items():
            flat[f"{key}__{int(n)}"] = np.asarray(values, np.float64)
    np.savez(path, **flat)


def load_timing_data(path):
    """Inverse of `save_timing_data`: .npz -> {key: {n: [ms, ...]}}."""
    timing_data = {}
    with np.load(path) as archive:
        for flat_key in archive.files:
            key, n = flat_key.rsplit("__", 1)
            timing_data.setdefault(key, {})[int(n)] = list(archive[flat_key])
    return timing_data


def analyze_dr_cvar_computation_time(sample_sizes=(10, 50, 100, 500, 1000,
                                                   1500),
                                     n_runs: int = 50, save_dir=None,
                                     params: Parameters | None = None,
                                     repeats: int = 20, seed: int = 0,
                                     dtype=jnp.float32, verbose=True,
                                     resume: bool = False, mesh=None):
    """Sweep sample sizes and time batched halfspace solves.

    Reference evaluation/timing_analysis.py:13-132.  Per size:
      * generates `n_runs` random Gaussian instances about [0.5, 0] with
        scale 0.1 and the fixed normal h=[1,1]/sqrt(2) (reference
        timing_analysis.py:58-70);
      * "setup": host->device transfer of the batch, measured fresh on
        EVERY repeat (rows are independent samples), amortized /n_runs;
      * "solve": wall-clock of the batched jitted solve including a
        device->host readback of the results / n_runs (the reference's
        wall-clock also measured result-available-on-host);
      * "call": setup + solve per instance.
    Records `repeats` timed repetitions for boxplot distributions; the
    first (compile) call is excluded, matching the reference's exclusion
    of CVXPY problem construction from its per-call numbers.

    With `resume=True` and a `save_dir`, sizes already present in
    `save_dir/timing_data.npz` are skipped and the checkpoint is
    extended -- long sweeps survive interruption.

    Pass a `jax.sharding.Mesh` with a `data` axis as `mesh` to shard
    each size's instance batch over devices
    (parallel/sweep.make_sharded_timing_solvers; the CLI's
    `--mode timing_analysis --mesh data=N` route).

    Returns the same timing_data dict structure as the reference
    (keys: {,cvar_}{setup,solve,call}_times -> {n: [ms, ...]}).
    """
    if params is None:
        params = Parameters()
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    npz_path = os.path.join(save_dir, "timing_data.npz") if save_dir else None

    keys = ["setup_times", "solve_times", "call_times",
            "cvar_setup_times", "cvar_solve_times", "cvar_call_times"]
    timing_data = {k: {n: [] for n in sample_sizes} for k in keys}
    done_sizes = set()
    if resume and npz_path and os.path.exists(npz_path):
        previous = load_timing_data(npz_path)
        for k, by_n in previous.items():
            for n, values in by_n.items():
                if values:
                    timing_data.setdefault(k, {})[n] = values
                    done_sizes.add(n)
        if verbose and done_sizes:
            print(f"Resuming: sizes {sorted(done_sizes)} loaded from "
                  f"{npz_path}")

    if mesh is not None:
        from ..parallel.sweep import make_sharded_timing_solvers
        dr_batch, cvar_batch = make_sharded_timing_solvers(mesh, params)
    else:
        dr_batch, cvar_batch = _make_batched_solvers(params)
    h = jnp.asarray(np.array([1.0, 1.0]) / np.sqrt(2.0), dtype)
    rng = np.random.default_rng(seed)

    for n_samples in sample_sizes:
        if n_samples in done_sizes:
            continue
        if verbose:
            print(f"Testing with {n_samples} samples...")
        # Kept as HOST numpy (in the target dtype) so each repeat times a
        # real host->device transfer: device_put of an already-committed
        # jax.Array transfers nothing and would only measure readback RTT.
        samples_np = np.asarray(
            np.array([0.5, 0.0])
            + 0.1 * rng.normal(size=(n_runs, n_samples, 2)),
            dtype=np.dtype(jnp.dtype(dtype).name))

        for solver, prefix in ((dr_batch, ""), (cvar_batch, "cvar_")):
            # Compile + first transfer (excluded, like the reference's
            # CVXPY problem construction).
            np.asarray(solver(jax.device_put(samples_np), h))
            for _ in range(repeats):
                # Setup: a fresh host->device transfer, completion forced
                # by reading one element back.
                t0 = time.perf_counter()
                samples = jax.device_put(samples_np)
                float(samples[0, 0, 0])
                setup_ms = (time.perf_counter() - t0) * 1e3 / n_runs

                t0 = time.perf_counter()
                np.asarray(solver(samples, h))
                solve_ms = (time.perf_counter() - t0) * 1e3 / n_runs
                timing_data[prefix + "setup_times"][n_samples].append(setup_ms)
                timing_data[prefix + "solve_times"][n_samples].append(solve_ms)
                timing_data[prefix + "call_times"][n_samples].append(
                    setup_ms + solve_ms)
        if npz_path:
            save_timing_data(timing_data, npz_path)  # checkpoint per size

    if importlib.util.find_spec("matplotlib") is not None:
        plot_timing_results(timing_data, list(sample_sizes), save_dir)
    create_comparison_table(timing_data, list(sample_sizes), save_dir,
                            verbose=verbose)
    return timing_data


def plot_timing_results(timing_data, sample_sizes, save_dir=None):
    """3-panel boxplots, filtered + unfiltered variants, same outlier
    thresholds and file names as reference timing_analysis.py:134-225.

    Also writes `timing_data.txt` -- the per-size outlier-removal
    provenance lines the reference publishes alongside the plots
    (reference results/Timing_Analysis/timing_data.txt, printed at
    reference timing_analysis.py:177-179)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    setup_threshold, solve_threshold, call_threshold = 2, 100, 400  # ms

    if save_dir:
        lines = []
        for n in sample_sizes:
            lines.append(f"Sample size {n}:")
            for key, thr, label in (
                    ("setup_times", setup_threshold, "Setup Time"),
                    ("solve_times", solve_threshold, "Solve Time"),
                    ("call_times", call_threshold, "Call Time")):
                arr = np.asarray(timing_data[key][n])
                removed = int((arr >= thr).sum())
                lines.append(f"  {label}: Removed {removed}/{len(arr)} "
                             f"outliers > {thr}ms")
        with open(os.path.join(save_dir, "timing_data.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")

    def panel(ax, key, threshold, title):
        data = []
        for n in sample_sizes:
            arr = np.asarray(timing_data[key][n])
            data.append(arr[arr < threshold] if threshold else arr)
        ax.boxplot(data, tick_labels=[str(n) for n in sample_sizes])
        ax.set_title(title)
        ax.set_ylabel("Time (ms)")

    for suffix, thresholds in (
        ("", (setup_threshold, solve_threshold, call_threshold)),
        ("_with_outliers", (None, None, None)),
    ):
        fig, axs = plt.subplots(3, 1, figsize=(10, 12))
        label = ("(outliers > {}ms removed)" if suffix == "" else
                 "(with outliers)")
        panel(axs[0], "setup_times", thresholds[0],
              f"Setup Time {label.format(setup_threshold)}")
        panel(axs[1], "solve_times", thresholds[1],
              f"Solve Time {label.format(solve_threshold)}")
        panel(axs[2], "call_times", thresholds[2],
              f"Call Time {label.format(call_threshold)}")
        axs[2].set_xlabel("Number Samples")
        fig.tight_layout()
        if save_dir:
            fig.savefig(os.path.join(
                save_dir, f"dr_cvar_computation_time{suffix}.png"))
        plt.close(fig)


def create_comparison_table(timing_data, sample_sizes, save_dir=None,
                            verbose=True):
    """Mean-timing table -> CSV, same columns as reference
    timing_analysis.py:228-275 (`timing_comparison.csv`).  Returns the
    rows (header first)."""
    rows = [["Samples", "DR-CVaR Setup", "DR-CVaR Solve", "DR-CVaR Call",
             "CVaR Setup", "CVaR Solve", "CVaR Call"]]
    for n in sample_sizes:
        rows.append([n] + [float(np.mean(timing_data[key][n])) for key in (
            "setup_times", "solve_times", "call_times", "cvar_setup_times",
            "cvar_solve_times", "cvar_call_times")])
    if verbose:
        print("\nTiming Comparison (times in ms):")
        for row in rows:
            print("  ".join(f"{v:>14.6f}" if isinstance(v, float)
                            else f"{v!s:>14}" for v in row))
    if save_dir:
        with open(os.path.join(save_dir, "timing_comparison.csv"), "w",
                  newline="") as fh:
            csv.writer(fh).writerows(rows)
    return rows
