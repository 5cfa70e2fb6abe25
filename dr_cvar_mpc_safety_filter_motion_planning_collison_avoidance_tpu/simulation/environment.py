"""Safety-filtering environment facade.

Counterpart of reference simulation/environment.py:8-140.
The reference's double loop over timesteps and obstacles (HOT LOOPS A/B,
environment.py:82-104 -> halfspaces.py:225-246; ~60-180 serial ECOS solves
per scenario) collapses here into ONE jitted call that evaluates every
(timestep x obstacle x risk-metric) halfspace as a batched reduction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.dynamics import create_double_integrator_matrices
from ..ops.halfspace import (Halfspace, cvar_halfspace, dr_cvar_halfspace,
                             mean_halfspace)


class SafeHalfspaces(NamedTuple):
    """All three risk metrics' halfspaces, batch shape [n_steps, n_obs].

    Counterpart of the reference's {'mean': [[...]], 'cvar': ..., 'dr_cvar':
    ...} nested-list structure (environment.py:75-106)."""

    mean: Halfspace
    cvar: Halfspace
    dr_cvar: Halfspace

    def by_metric(self, metric: str) -> Halfspace:
        return getattr(self, "dr_cvar" if metric == "dr_cvar" else metric)


@dataclasses.dataclass(frozen=True, eq=False)
class Environment:
    """Owns radii, horizon, risk parameters and system matrices
    (reference simulation/environment.py:12-47)."""

    robot_radius: float
    obstacle_radius: float
    horizon: int
    dt: float
    alpha: float
    delta: float
    epsilon: float
    dtype: object = jnp.float32

    def __post_init__(self):
        A, B, C = create_double_integrator_matrices(self.dt, dtype=self.dtype)
        object.__setattr__(self, "A", A)
        object.__setattr__(self, "B", B)
        object.__setattr__(self, "C", C)

    @property
    def n_states(self):
        return self.A.shape[0]

    @property
    def n_inputs(self):
        return self.B.shape[1]

    @property
    def n_outputs(self):
        return self.C.shape[0]


def _use_kernel(env: Environment, n_samples: int) -> bool:
    """Production GPU path: the fused Pallas kernel (one sample read for
    all three metrics) when running float32 on a GPU backend with rows
    no wider than `KERNEL_MAX_N`; the batched XLA closed form otherwise
    (CPU, float64, wider rows).  Respects a `jax.default_device(...)`
    override (e.g. the CPU cross-check run from a GPU process).

    Also off under `jax_enable_x64`: Python constants in the kernel body
    would widen to 64 bits, and a process mixing float64 parity checks
    with GPU runs takes the XLA closed form instead."""
    from ..ops.pallas_kernels import KERNEL_MAX_N

    if jax.config.jax_enable_x64:
        return False
    default_dev = jax.config.jax_default_device
    # jax_default_device may be a Device OR a platform string.
    platform = (getattr(default_dev, "platform", default_dev)
                if default_dev is not None
                else jax.default_backend())
    return (env.dtype == jnp.float32 and platform == "gpu"
            and n_samples <= KERNEL_MAX_N)


@functools.partial(jax.jit, static_argnames=("env", "use_kernel"))
def compute_safe_halfspaces_for_trajectory(env: Environment,
                                           obstacle_samples, x_ref,
                                           use_kernel: bool | None = None
                                           ) -> SafeHalfspaces:
    """Halfspaces for every (t, obstacle, metric) in one fused call.

    Reference simulation/environment.py:60-106: for t in range(n_steps),
    slice per-obstacle samples [:, t, :], take ego ref position C@x_ref[t],
    and build mean/CVaR/DR-CVaR halfspaces.  Here the loop axes become
    array axes, and on the GPU the three metrics are computed by ONE
    fused Pallas kernel pass over the samples (ops/pallas_kernels.py).

    Args:
      obstacle_samples: [n_obs, n_samples, T+1, 2] stacked sample
        trajectories (T+1 >= n_steps).
      x_ref: [H+1, n_states] ego reference trajectory.
      use_kernel: force the kernel path (True), the XLA path (False) or
        pick by platform, dtype and N (None).
    Returns:
      SafeHalfspaces with batch shape [n_steps, n_obs], where
      n_steps = min(len(x_ref), horizon) (environment.py:71).
    """
    # Clamp to the obstacle data's length too: with a per-scenario
    # sim_time shorter than horizon*dt (paper presets, 3-5 s vs 6 s)
    # there are simply no obstacle samples beyond the simulation end --
    # the reference builds soft MPC constraints only for timesteps that
    # have halfspaces (reference core/mpc_filter.py:119
    # `if t-1 < len(safe_halfspaces)`); models/pipeline.py pads the
    # missing rows as inactive constraints.
    n_steps = min(x_ref.shape[0], env.horizon, obstacle_samples.shape[2])
    n_obs, n_samples = obstacle_samples.shape[0], obstacle_samples.shape[1]
    if use_kernel is None:
        use_kernel = _use_kernel(env, n_samples)
    # [n_obs, N, n_steps, 2] -> [n_steps, n_obs, N, 2]
    samples_t = jnp.transpose(obstacle_samples[:, :, :n_steps, :],
                              (2, 0, 1, 3)).astype(env.dtype)
    # HIGHEST precision: a default-precision f32 product may run in TF32
    # on the GPU (~1e-3 relative), which would round the ego positions
    # before they reach the halfspace solvers.
    ego_pos = jnp.einsum("tn,pn->tp", x_ref[:n_steps].astype(env.dtype),
                         env.C, precision=jax.lax.Precision.HIGHEST)

    if use_kernel:
        from ..ops.pallas_kernels import fused_metric_halfspaces
        B = n_steps * n_obs
        ego_flat = jnp.broadcast_to(ego_pos[:, None, :],
                                    (n_steps, n_obs, 2)).reshape(B, 2)
        hm, gm, h, gc, gd = fused_metric_halfspaces(
            samples_t.reshape(B, n_samples, 2), ego_flat, env.alpha,
            env.delta, env.epsilon, env.robot_radius, env.obstacle_radius)
        shape2 = (n_steps, n_obs, 2)
        shape1 = (n_steps, n_obs)
        return SafeHalfspaces(
            mean=Halfspace(hm.reshape(shape2), gm.reshape(shape1)),
            cvar=Halfspace(h.reshape(shape2), gc.reshape(shape1)),
            dr_cvar=Halfspace(h.reshape(shape2), gd.reshape(shape1)),
        )

    ego_pos_b = ego_pos[:, None, :]                            # broadcast obs
    mean_hs = mean_halfspace(samples_t, env.robot_radius, env.obstacle_radius)
    cvar_hs = cvar_halfspace(samples_t, ego_pos_b, env.alpha, env.delta,
                             env.robot_radius, env.obstacle_radius)
    dr_hs = dr_cvar_halfspace(samples_t, ego_pos_b, env.alpha, env.delta,
                              env.epsilon, env.robot_radius,
                              env.obstacle_radius)
    return SafeHalfspaces(mean=mean_hs, cvar=cvar_hs, dr_cvar=dr_hs)


@functools.partial(jax.jit, static_argnames=("env",))
def compute_distance_to_collision(env: Environment, ego_trajectory,
                                  obstacle_trajectories):
    """Signed distance to the nearest obstacle at each step.

    Reference simulation/environment.py:108-140: min over obstacles of
    ||C x_t - obs_t|| - r_robot - r_obs, over
    n_steps = min(len(ego), len(obs)).

    Args:
      ego_trajectory: [T_e+1, n_states].
      obstacle_trajectories: [n_obs, T_o+1, 2].
    Returns: [min(T_e, T_o)+1] distances.
    """
    n_steps = min(ego_trajectory.shape[0], obstacle_trajectories.shape[1])
    ego_pos = jnp.einsum("tn,pn->tp",                          # [T, 2]
                         ego_trajectory[:n_steps].astype(env.dtype), env.C,
                         precision=jax.lax.Precision.HIGHEST)
    obs_pos = obstacle_trajectories[:, :n_steps, :].astype(env.dtype)
    dist = jnp.linalg.norm(ego_pos[None, :, :] - obs_pos, axis=-1)
    dist = dist - env.robot_radius - env.obstacle_radius
    return jnp.min(dist, axis=0)
