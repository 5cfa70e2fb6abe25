"""CPU tests of what surrounds the GPU path: the MPC solver's plain XLA
Cholesky under (nested) vmap, the halfspace kernel's dispatch choice and
launch handling, and one check that runs only on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.halfspace import (
    cvar_halfspace, dr_cvar_halfspace, mean_halfspace)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.pallas_kernels import (
    KERNEL_MAX_N, fused_metric_halfspaces)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
    solve_mpc_qp)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.simulation import (
    environment as env_mod)

RADII = (0.3, 0.3)


def _qp(rng, n=8, m1=4, m2=5):
    """A feasible slack-structured QP (see ops/qp_ipm_structured.py)."""
    M = rng.normal(size=(n, n))
    return dict(P_uu=jnp.asarray(M @ M.T + 3.0 * np.eye(n)),
                q_u=jnp.asarray(rng.normal(size=n)),
                G_u=jnp.asarray(rng.normal(size=(m1, n))),
                h1=jnp.asarray(np.full(m1, 5.0)),
                A=jnp.asarray(rng.normal(size=(m2, n))),
                b=jnp.asarray(rng.normal(size=m2)))


def test_nested_vmap_mpc_solves_match_per_instance():
    """vmap(vmap(solve)) with the plain XLA Cholesky equals solving each
    instance alone (the pipeline nests the metric vmap in a batch vmap)."""
    rng = np.random.default_rng(0)
    base = _qp(rng)
    q = jnp.asarray(rng.normal(size=(3, 4, base["q_u"].shape[0])))
    b = jnp.asarray(rng.normal(size=(3, 4, base["b"].shape[0])))

    def solve(qi, bi):
        return solve_mpc_qp(base["P_uu"], qi, base["G_u"], base["h1"],
                            base["A"], bi, 50.0, 50.0).u

    nested = jax.jit(jax.vmap(jax.vmap(solve)))(q, b)
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(np.asarray(nested[i, j]),
                                       np.asarray(solve(q[i, j], b[i, j])),
                                       rtol=1e-9, atol=1e-9)


def test_cho_solve_unbatched_factor_under_vmap():
    """A closed-over (unbatched) factor under vmap broadcasts, as the
    constant MPC Hessian does when only right-hand sides vary."""
    from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.qp_ipm_structured import (
        _factor, _solve)
    rng = np.random.default_rng(11)
    M = rng.normal(size=(16, 16))
    S = jnp.asarray(M @ M.T + 3.0 * np.eye(16))
    r = jnp.asarray(rng.normal(size=(4, 16)))
    x = jax.vmap(lambda ri: _solve(_factor(S), ri))(r)
    np.testing.assert_allclose(np.asarray(S @ x.T).T, np.asarray(r),
                               atol=1e-9)


def _env(dtype=jnp.float32):
    return env_mod.Environment(robot_radius=0.3, obstacle_radius=0.3,
                               horizon=3, dt=0.2, alpha=0.2, delta=0.1,
                               epsilon=0.15, dtype=dtype)


@pytest.mark.parametrize("case,expected", [
    ("gpu_f32", True),
    ("cpu", False),
    ("gpu_x64", False),
    ("gpu_f64_env", False),
    ("gpu_wide_rows", False),
    ("gpu_default_device_cpu", False),
])
def test_kernel_dispatch(monkeypatch, case, expected):
    """The fused kernel runs only for float32 on a GPU backend with rows
    no wider than KERNEL_MAX_N; everything else takes the XLA form."""
    backend = "cpu" if case == "cpu" else "gpu"
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    env = _env(jnp.float64 if case == "gpu_f64_env" else jnp.float32)
    n = KERNEL_MAX_N + 1 if case == "gpu_wide_rows" else 1000
    x64_was = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", case == "gpu_x64")
        if case == "gpu_default_device_cpu":
            with jax.default_device(jax.devices("cpu")[0]):
                assert env_mod._use_kernel(env, n) is expected
        else:
            assert env_mod._use_kernel(env, n) is expected
    finally:
        jax.config.update("jax_enable_x64", x64_was)


@pytest.mark.parametrize("B,N,rows", [(1, 7, None), (5, 33, 2),
                                      (13, 100, 4), (3, 1025, 1)])
def test_kernel_padding_odd_batch_and_width(B, N, rows):
    """Rows past B and columns past N are masked loads: any batch, any
    width and any power-of-two rows per program give the closed forms."""
    rng = np.random.default_rng(B * 1000 + N)
    s = jnp.asarray(np.array([0.5, 0.0]) + 0.1 * rng.normal(size=(B, N, 2)),
                    jnp.float32)
    e = jnp.asarray(0.1 * rng.normal(size=(B, 2)), jnp.float32)
    hm, gm, h, gc, gd = fused_metric_halfspaces(
        s, e, 0.2, 0.1, 0.15, *RADII, rows=rows, interpret=True)
    m = mean_halfspace(s, *RADII)
    c = cvar_halfspace(s, e, 0.2, 0.1, *RADII)
    d = dr_cvar_halfspace(s, e, 0.2, 0.1, 0.15, *RADII)
    for got, want in ((hm, m.h), (gm, m.g_tilde), (h, c.h),
                      (gc, c.g_tilde), (gd, d.g_tilde)):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(want).astype(np.float32),
                                   atol=2e-5)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX has none (the suite runs on the
    CPU; chip_smoke.py runs the compiled checks on the card)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    rng = np.random.default_rng(1)
    with jax.default_device(gpu_device):
        s = jnp.asarray(rng.normal(size=(64, 1000, 2)), jnp.float32)
        e = jnp.asarray(rng.normal(size=(64, 2)), jnp.float32)
        gd = fused_metric_halfspaces(s, e, 0.2, 0.1, 0.15, *RADII)[4]
        ref = dr_cvar_halfspace(s, e, 0.2, 0.1, 0.15, *RADII).g_tilde
    np.testing.assert_allclose(np.asarray(gd), np.asarray(ref), atol=2e-5)
