"""Evaluation-layer tests: metrics, timing analysis, visualization,
utils, and the Pallas halfspace kernel in interpreter mode."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.metrics import (
    collision_rate, expectation_of_shortfall, safety_metrics)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils.math_utils import (
    is_point_in_halfspace, normalize_vector, project_point_to_halfspace)


def test_collision_rate():
    d = jnp.asarray([-1.0, 0.5, -0.2, 1.0])
    assert float(collision_rate(d)) == 0.5


def test_expectation_of_shortfall():
    d = jnp.asarray([-1.0, 0.5, -0.5, 1.0])
    # mean of shortfalls below 0: (-1.0 + -0.5)/2 = -0.75
    assert float(expectation_of_shortfall(d)) == pytest.approx(-0.75)
    # no shortfalls -> 0 (reference evaluation/metrics.py:29-30)
    assert float(expectation_of_shortfall(jnp.asarray([0.1, 0.2]))) == 0.0


def test_safety_metrics_keys():
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=100))
    m = safety_metrics(d)
    expected = {"mean", "min", "max", "std", "collision_rate",
                "expected_shortfall", "q10", "q25", "median", "q75", "q90"}
    assert set(m) == expected
    np.testing.assert_allclose(float(m["median"]),
                               np.median(np.asarray(d)), atol=1e-9)


def test_normalize_vector():
    v = jnp.asarray([3.0, 4.0])
    np.testing.assert_allclose(np.asarray(normalize_vector(v)), [0.6, 0.8])
    np.testing.assert_allclose(
        np.asarray(normalize_vector(jnp.zeros(2))), [0.0, 0.0])


def test_halfspace_membership_and_projection():
    h = jnp.asarray([1.0, 0.0])
    g = -1.0  # halfspace: x <= 1
    assert bool(is_point_in_halfspace(jnp.asarray([0.5, 7.0]), h, g))
    assert not bool(is_point_in_halfspace(jnp.asarray([2.0, 0.0]), h, g))
    proj = project_point_to_halfspace(jnp.asarray([2.0, 3.0]), h, g)
    np.testing.assert_allclose(np.asarray(proj), [1.0, 3.0], atol=1e-12)
    inside = project_point_to_halfspace(jnp.asarray([0.2, 3.0]), h, g)
    np.testing.assert_allclose(np.asarray(inside), [0.2, 3.0], atol=1e-12)


def test_timing_analysis_smoke(tmp_path):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.timing_analysis import (
        analyze_dr_cvar_computation_time)
    data = analyze_dr_cvar_computation_time(
        sample_sizes=(10, 30), n_runs=4, repeats=3,
        save_dir=str(tmp_path), dtype=jnp.float64, verbose=False)
    assert set(data) == {"setup_times", "solve_times", "call_times",
                         "cvar_setup_times", "cvar_solve_times",
                         "cvar_call_times"}
    assert len(data["solve_times"][10]) == 3
    assert os.path.exists(tmp_path / "timing_comparison.csv")
    assert os.path.exists(tmp_path / "dr_cvar_computation_time.png")
    assert os.path.exists(tmp_path / "dr_cvar_computation_time_with_outliers.png")


def test_timing_analysis_npz_checkpoint_and_resume(tmp_path):
    """Sweeps checkpoint per size to timing_data.npz and resume=True
    skips already-measured sizes (SURVEY.md section 5 checkpoint/resume)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.timing_analysis import (
        analyze_dr_cvar_computation_time, load_timing_data)
    first = analyze_dr_cvar_computation_time(
        sample_sizes=(10,), n_runs=4, repeats=3,
        save_dir=str(tmp_path), dtype=jnp.float64, verbose=False)
    npz = tmp_path / "timing_data.npz"
    assert npz.exists()
    loaded = load_timing_data(str(npz))
    np.testing.assert_allclose(loaded["solve_times"][10],
                               first["solve_times"][10])
    # Resume with an extra size: size 10 must come back verbatim (not
    # re-measured), size 30 measured fresh.
    merged = analyze_dr_cvar_computation_time(
        sample_sizes=(10, 30), n_runs=4, repeats=3,
        save_dir=str(tmp_path), dtype=jnp.float64, verbose=False,
        resume=True)
    np.testing.assert_allclose(merged["solve_times"][10],
                               first["solve_times"][10])
    assert len(merged["solve_times"][30]) == 3


def test_mc_result_npz_roundtrip(tmp_path):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.evaluation.monte_carlo import (
        MonteCarloResult, load_mc_result, save_mc_result)
    rng = np.random.default_rng(5)
    md = rng.normal(size=(7, 4))
    result = MonteCarloResult(
        min_distances=jnp.asarray(md),
        collisions=jnp.asarray(md < 0),
        collision_probs=jnp.asarray((md < 0).mean(axis=0)),
        qp_converged=jnp.ones((7, 3), bool))
    path = tmp_path / "mc.npz"
    save_mc_result(result, str(path))
    loaded = load_mc_result(str(path))
    for f in MonteCarloResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)),
                                      np.asarray(getattr(result, f)))


def test_visualization_smoke(tmp_path):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
        visualization as viz)
    rng = np.random.default_rng(0)
    ego = np.cumsum(rng.normal(size=(20, 4)) * 0.1, axis=0)
    obs = np.cumsum(rng.normal(size=(2, 20, 2)) * 0.1, axis=1)
    hs_h = rng.normal(size=(10, 2, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = rng.normal(size=(10, 2))

    viz.plot_scenario(ego, obs, 0.3, 0.3,
                      save_path=str(tmp_path / "scenario.png"))
    viz.plot_distance_to_collision(
        {"a": rng.normal(size=20), "b": rng.normal(size=20)},
        save_path=str(tmp_path / "dist.png"))
    viz.compare_risk_metrics(
        {"mean": rng.normal(size=30), "dr_cvar": rng.normal(size=30)},
        save_path=str(tmp_path / "cmp.png"))
    viz.visualize_trajectory_with_halfspaces(
        ego, obs, hs_h, hs_g, 0.3, 0.3,
        save_path=str(tmp_path / "hs.png"))
    for f in ["scenario.png", "dist.png", "cmp.png", "hs.png"]:
        assert os.path.exists(tmp_path / f)


def test_animation_smoke(tmp_path):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
        visualization as viz)
    rng = np.random.default_rng(1)
    ego = np.cumsum(rng.normal(size=(6, 4)) * 0.1, axis=0)
    obs = np.cumsum(rng.normal(size=(1, 6, 2)) * 0.1, axis=1)
    # With halfspaces: exercises boundary lines AND safe-direction
    # arrows (reference simulation/visualization.py:330-347).
    hs_h = rng.normal(size=(6, 1, 2))
    hs_h /= np.linalg.norm(hs_h, axis=-1, keepdims=True)
    hs_g = rng.normal(size=(6, 1))
    # mp4 save falls back to GIF when ffmpeg is unavailable
    viz.animate_scenario(ego, obs, 0.3, 0.3, hs_h, hs_g,
                         save_path=str(tmp_path / "anim.mp4"))
    assert (os.path.exists(tmp_path / "anim.mp4")
            or os.path.exists(tmp_path / "anim.gif"))


def test_pallas_kernel_interpret_mode():
    """Fused Pallas kernel's DR-CVaR output equals the XLA closed form
    (interpreter mode on CPU; the compiled Triton kernel is checked on
    the card by chip_smoke.py)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_halfspace)
    rng = np.random.default_rng(2)
    B, N = 8, 50
    samples = jnp.asarray(rng.normal(size=(B, N, 2)), jnp.float32)
    ego = jnp.asarray(rng.normal(size=(B, 2)), jnp.float32)
    h_k, g_k = _kernel_drcvar(samples, ego, 0.2)
    ref = dr_cvar_halfspace(samples, ego, 0.2, 0.1, 0.15, 0.3, 0.3)
    np.testing.assert_allclose(np.asarray(h_k), np.asarray(ref.h),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_k),
                               np.asarray(ref.g_tilde).astype(np.float32),
                               atol=1e-5)


def _kernel_drcvar(samples, ego, alpha, **launch):
    """(h, g_drcvar) of the fused kernel in interpret mode."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        fused_metric_halfspaces)
    _, _, h, _, gd = fused_metric_halfspaces(
        samples, ego, alpha, 0.1, 0.15, 0.3, 0.3, interpret=True, **launch)
    return h, gd


def test_pallas_all_metrics_interpret_mode():
    """Fused all-metrics Pallas kernel (the production GPU halfspace
    path) equals the XLA closed forms for mean, CVaR AND DR-CVaR in one
    pass (interpreter mode on CPU; compiled path checked by
    chip_smoke.py)."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        cvar_halfspace, dr_cvar_halfspace, mean_halfspace)
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        fused_metric_halfspaces)
    rng = np.random.default_rng(3)
    B, N = 11, 50   # non-multiple of the tile to exercise padding
    samples = jnp.asarray(rng.normal(size=(B, N, 2)), jnp.float32)
    ego = jnp.asarray(rng.normal(size=(B, 2)), jnp.float32)
    hm, gm, h, gc, gd = fused_metric_halfspaces(
        samples, ego, 0.2, 0.1, 0.15, 0.3, 0.3, interpret=True)
    m_ref = mean_halfspace(samples, 0.3, 0.3)
    c_ref = cvar_halfspace(samples, ego, 0.2, 0.1, 0.3, 0.3)
    d_ref = dr_cvar_halfspace(samples, ego, 0.2, 0.1, 0.15, 0.3, 0.3)
    f32 = lambda x: np.asarray(x).astype(np.float32)
    # h tolerance 5e-6: kernel and XLA closed form are different f32
    # programs; their ~1e-7 reduction-order difference on the mean is
    # amplified by the h-normalization when ||mean - ego|| is small.
    np.testing.assert_allclose(np.asarray(hm), f32(m_ref.h), atol=5e-6)
    np.testing.assert_allclose(np.asarray(gm), f32(m_ref.g_tilde), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), f32(c_ref.h), atol=5e-6)
    np.testing.assert_allclose(np.asarray(gc), f32(c_ref.g_tilde), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), f32(d_ref.h), atol=5e-6)
    np.testing.assert_allclose(np.asarray(gd), f32(d_ref.g_tilde), atol=1e-5)


def test_environment_pallas_path_interpret(monkeypatch):
    """compute_safe_halfspaces_for_trajectory(use_kernel=True) matches
    the XLA path on the same inputs (kernel forced to interpret mode
    via monkeypatching, since tests run on CPU)."""
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels as pk
    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.environment as env_mod

    orig = pk.fused_metric_halfspaces

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk, "fused_metric_halfspaces", interp)

    env = env_mod.Environment(robot_radius=0.3, obstacle_radius=0.3,
                              horizon=6, dt=0.2, alpha=0.2, delta=0.1,
                              epsilon=0.15, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    samples = jnp.asarray(rng.normal(size=(2, 20, 7, 2)), jnp.float32)
    x_ref = jnp.asarray(np.cumsum(rng.normal(size=(7, 4)), axis=0),
                        jnp.float32)
    hs_pl = env_mod.compute_safe_halfspaces_for_trajectory(
        env, samples, x_ref, use_kernel=True)
    hs_ref = env_mod.compute_safe_halfspaces_for_trajectory(
        env, samples, x_ref, use_kernel=False)
    for m in ("mean", "cvar", "dr_cvar"):
        np.testing.assert_allclose(
            np.asarray(hs_pl.by_metric(m).h),
            np.asarray(hs_ref.by_metric(m).h), atol=5e-6)
        np.testing.assert_allclose(
            np.asarray(hs_pl.by_metric(m).g_tilde),
            np.asarray(hs_ref.by_metric(m).g_tilde), atol=1e-5)


def test_timer_and_stats(capsys):
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils.timing import (
        Timer, TimingStats)
    with Timer("unit") as t:
        sum(range(1000))
    assert t.elapsed > 0
    stats = TimingStats()
    stats.add("x", 1.0)
    stats.add("x", 3.0)
    s = stats.get_stats("x")
    assert s["mean"] == 2.0 and s["count"] == 2
    assert stats.get_stats("missing") is None


def test_profiler_trace_hook(tmp_path):
    """`utils.trace` captures a jax.profiler device trace (SURVEY §5
    tracing row: the optional deep-profiling hook), and is a no-op when
    no directory is given."""
    import jax.numpy as jnp

    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.utils import (
        annotate, trace)

    with trace(None):     # no-op path
        pass

    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with annotate("unit-region"):
            jnp.dot(jnp.ones((8, 8)), jnp.ones((8, 8))).block_until_ready()
    produced = list((tmp_path / "trace").rglob("*"))
    assert any(p.suffix in (".pb", ".gz", ".json") or "trace" in p.name
               for p in produced if p.is_file()), produced


@pytest.mark.parametrize("case", ["ties", "constant", "outlier",
                                  "negative", "laplace", "alpha_mid"])
def test_pallas_select_adversarial_data(case):
    """The moment-seeded select must stay EXACT on
    data its Gaussian round-1 pivots mis-bracket: heavy ties, constant
    rows, huge outliers (inflated sigma), all-negative quantiles, heavy
    tails, and mid-range alpha."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_halfspace)
    rng = np.random.default_rng(7)
    B, N = 8, 64
    alpha = 0.5 if case == "alpha_mid" else 0.2
    if case == "ties":
        vals = rng.choice(np.asarray([-1.0, 0.0, 0.25, 2.0], np.float32),
                          size=(B, N, 2))
    elif case == "constant":
        vals = np.broadcast_to(
            rng.normal(size=(B, 1, 2)), (B, N, 2)).copy()
    elif case == "outlier":
        vals = 0.01 * rng.normal(size=(B, N, 2))
        vals[:, 0, :] = 500.0   # one huge sample inflates sigma ~50x
    elif case == "negative":
        vals = -10.0 + 0.1 * rng.normal(size=(B, N, 2))
    elif case == "laplace":
        vals = rng.laplace(scale=0.5, size=(B, N, 2))
    else:
        vals = rng.normal(size=(B, N, 2))
    samples = jnp.asarray(vals, jnp.float32)
    ego = jnp.asarray(rng.normal(size=(B, 2)), jnp.float32)
    h_k, g_k = _kernel_drcvar(samples, ego, alpha)
    ref = dr_cvar_halfspace(samples, ego, alpha, 0.1, 0.15, 0.3, 0.3)
    np.testing.assert_allclose(np.asarray(g_k),
                               np.asarray(ref.g_tilde).astype(np.float32),
                               atol=2e-4, rtol=1e-5)


def test_pallas_select_large_n_3ary_path():
    """n_samples >= 1024 takes the 11-bit dual-packed 3-ary count path
    (the 10-bit triple packing would overflow); exactness must hold at
    the timing sweep's N=1500 end."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_halfspace)
    rng = np.random.default_rng(17)
    samples = jnp.asarray(
        np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(6, 1500, 2)),
        jnp.float32)
    ego = jnp.asarray(0.1 * rng.normal(size=(6, 2)), jnp.float32)
    h_k, g_k = _kernel_drcvar(samples, ego, 0.2)
    ref = dr_cvar_halfspace(samples, ego, 0.2, 0.1, 0.15, 0.3, 0.3)
    np.testing.assert_allclose(np.asarray(g_k),
                               np.asarray(ref.g_tilde).astype(np.float32),
                               atol=2e-4, rtol=1e-5)


def test_pallas_kernel_shape_guards():
    """Packed-count overflow (n > 32767: a 15-bit dual field would reach
    the int32 sign bit) and a row count that is not a power of two (a
    Triton block shape) must raise at trace time, not corrupt results
    silently."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        fused_metric_halfspaces)
    ego = jnp.zeros((8, 2), jnp.float32)
    with pytest.raises(ValueError, match="n_samples"):
        fused_metric_halfspaces(jnp.zeros((8, 32800, 2), jnp.float32), ego,
                                0.2, 0.1, 0.15, 0.3, 0.3, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        fused_metric_halfspaces(jnp.zeros((8, 1000, 2), jnp.float32), ego,
                                0.2, 0.1, 0.15, 0.3, 0.3, rows=3,
                                interpret=True)


def test_pallas_select_n4096_wide_field_path():
    """N=4096 (the widest row the production path sends to the kernel)
    must stay EXACT on the widened 13-bit dual-packed count path."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
        dr_cvar_halfspace)
    rng = np.random.default_rng(23)
    samples = jnp.asarray(
        np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(4, 4096, 2)),
        jnp.float32)
    ego = jnp.asarray(0.1 * rng.normal(size=(4, 2)), jnp.float32)
    h_k, g_k = _kernel_drcvar(samples, ego, 0.2)
    ref = dr_cvar_halfspace(samples, ego, 0.2, 0.1, 0.15, 0.3, 0.3)
    np.testing.assert_allclose(np.asarray(g_k),
                               np.asarray(ref.g_tilde).astype(np.float32),
                               atol=2e-4, rtol=1e-5)


def test_environment_xla_fallback_above_kernel_n_limit(monkeypatch):
    """N above the kernel's row width on a (simulated) GPU backend must
    auto-route to the XLA closed form instead of the kernel."""
    import jax

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation.environment as env_mod
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
        KERNEL_MAX_N)

    x64_was = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", False)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        env = env_mod.Environment(robot_radius=0.3, obstacle_radius=0.3,
                                  horizon=3, dt=0.2, alpha=0.2, delta=0.1,
                                  epsilon=0.15, dtype=jnp.float32)
        rng = np.random.default_rng(5)
        samples = jnp.asarray(rng.normal(size=(1, KERNEL_MAX_N + 1, 4, 2)),
                              jnp.float32)
        x_ref = jnp.asarray(np.cumsum(rng.normal(size=(4, 4)), axis=0),
                            jnp.float32)
        # Routed to the kernel, a compiled (non-interpret) Triton call
        # would fail to lower on the CPU; the N-gate sends it to XLA.
        hs = env_mod.compute_safe_halfspaces_for_trajectory(
            env, samples, x_ref)
        assert np.isfinite(np.asarray(hs.dr_cvar.g_tilde)).all()
    finally:
        jax.config.update("jax_enable_x64", x64_was)
