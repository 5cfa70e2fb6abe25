"""Reference trajectory planners.

Counterpart of reference simulation/planner.py:8-197.

* `straight_line_trajectory` replicates the analytic constant-velocity
  line interpolation (reference simulation/planner.py:120-197), fully
  vectorized and jit/vmap-safe.  Divergence from the reference, on
  purpose: when the goal is closer than one step (n_steps == 0 but
  distance >= 1e-10) the reference raises ZeroDivisionError
  (planner.py:169 `t / n_steps`); here the trajectory snaps to the goal.

* `plan_trajectory` restores the goal-tracking QP planner (reference
  simulation/planner.py:36-118 -- dead code there, live API here) using
  the same condensed interior-point machinery as the MPC filter.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dynamics import condensed_dynamics
from ..ops.qp_ipm import solve_qp


@dataclasses.dataclass(frozen=True, eq=False)
class Planner:
    """Holds system matrices and horizon (reference planner.py:8-34)."""

    A: jax.Array
    B: jax.Array
    C: jax.Array
    q_weight: float
    r_weight: float
    horizon: int
    dt: float

    @property
    def n_states(self):
        return self.A.shape[0]

    @property
    def n_inputs(self):
        return self.B.shape[1]


@functools.partial(jax.jit, static_argnames=("planner",))
def straight_line_trajectory(planner: Planner, start_pos, goal_pos,
                             velocity: float = 1.5):
    """Constant-velocity straight-line reference with recovered inputs.

    Reference simulation/planner.py:120-197.  Returns (x_ref [H+1, n],
    u_ref [H, m]).  Inputs are recovered via u_t = B^+ (x_{t+1} - A x_t)
    (planner.py:185-187).
    """
    H = planner.horizon
    n = planner.n_states
    dtype = planner.A.dtype
    start_pos = start_pos.astype(dtype)
    goal_pos = goal_pos.astype(dtype)

    diff = goal_pos - start_pos
    distance = jnp.linalg.norm(diff)
    degenerate = distance < 1e-10
    safe_dist = jnp.where(degenerate, 1.0, distance)
    direction = diff / safe_dist

    time_to_goal = distance / velocity
    n_steps = jnp.floor(time_to_goal / planner.dt).astype(jnp.int32)

    t = jnp.arange(1, H + 1, dtype=dtype)
    moving = t <= n_steps.astype(dtype)
    progress = t / jnp.maximum(n_steps.astype(dtype), 1.0)
    pos = jnp.where(moving[:, None],
                    start_pos[None, :] + progress[:, None] * diff[None, :],
                    goal_pos[None, :])
    vel = jnp.where(moving[:, None],
                    velocity * direction[None, :],
                    jnp.zeros((1, 2), dtype))

    x_ref = jnp.zeros((H + 1, n), dtype)
    x_ref = x_ref.at[0, :2].set(start_pos)
    x_ref = x_ref.at[1:, :2].set(pos)
    x_ref = x_ref.at[1:, 2:].set(vel)

    # Degenerate start==goal: stationary trajectory at start_pos with the
    # reference's quirk of writing start into BOTH position and velocity
    # slots (planner.py:152 `x_ref[:, :2] = start_pos` on a [H+1,4] array
    # only sets positions -- so here: positions=start, velocities=0).
    x_stat = jnp.zeros((H + 1, n), dtype).at[:, :2].set(start_pos[None, :])
    x_ref = jnp.where(degenerate, x_stat, x_ref)

    # HIGHEST precision: a TF32 product (the GPU's default f32 precision
    # may use it) would inject ~1e-3 relative error into the recovered
    # inputs; these are 4x4/4x2 products.
    with jax.default_matmul_precision("highest"):
        B_pinv = jnp.linalg.pinv(planner.B)
        u_ref = (x_ref[1:] - x_ref[:-1] @ planner.A.T) @ B_pinv.T
    u_ref = jnp.where(degenerate, jnp.zeros_like(u_ref), u_ref)

    info = {
        "distance": distance,
        "time_to_goal": time_to_goal,
        "n_steps": n_steps,
    }
    return x_ref, u_ref, info


@dataclasses.dataclass(frozen=True, eq=False)
class _CondensedPlan:
    Phi: jax.Array
    Gamma: jax.Array
    P: jax.Array


@functools.partial(jax.jit, static_argnames=("planner", "has_bounds"))
def plan_trajectory(planner: Planner, x0, goal_state,
                    input_bounds=None, state_bounds=None,
                    has_bounds: bool = False):
    """Goal-tracking QP planner (reference simulation/planner.py:36-118).

    Minimizes sum_t (x_{t+1}-goal)'Q(x_{t+1}-goal) + u_t'Ru_t subject to
    dynamics, and optional input/state boxes.  Condensed to input space
    and solved with the batched IPM.  Returns (x_ref, u_ref, info).
    """
    with jax.default_matmul_precision("highest"):
        return _plan_trajectory_body(planner, x0, goal_state, input_bounds,
                                     state_bounds, has_bounds)


def _plan_trajectory_body(planner, x0, goal_state, input_bounds,
                          state_bounds, has_bounds):
    H = planner.horizon
    n, m = planner.n_states, planner.n_inputs
    dtype = planner.A.dtype
    Phi, Gamma = condensed_dynamics(planner.A, planner.B, H)

    n_u = H * m
    P = 2.0 * (planner.q_weight * Gamma.T @ Gamma
               + planner.r_weight * jnp.eye(n_u, dtype=dtype))
    goal_tile = jnp.tile(goal_state.astype(dtype), H)
    e0 = Phi @ x0.astype(dtype) - goal_tile
    q = 2.0 * planner.q_weight * (Gamma.T @ e0)

    if not has_bounds:
        # Unconstrained: exact Newton solve.
        u = -jnp.linalg.solve(P, q)
        converged = jnp.asarray(True)
    else:
        u_min, u_max = input_bounds
        x_min, x_max = state_bounds
        eye_u = jnp.eye(n_u, dtype=dtype)
        phi_x0 = Phi @ x0.astype(dtype)
        G = jnp.concatenate([eye_u, -eye_u, Gamma, -Gamma], axis=0)
        h = jnp.concatenate([
            jnp.tile(jnp.asarray(u_max, dtype), H),
            -jnp.tile(jnp.asarray(u_min, dtype), H),
            jnp.tile(jnp.asarray(x_max, dtype), H) - phi_x0,
            phi_x0 - jnp.tile(jnp.asarray(x_min, dtype), H),
        ])
        sol = solve_qp(P, q, G, h)
        u = sol.z
        converged = sol.converged

    u_ref = u.reshape(H, m)
    X = (Phi @ x0.astype(dtype) + Gamma @ u).reshape(H, n)
    x_ref = jnp.concatenate([x0.astype(dtype)[None, :], X], axis=0)
    info = {"converged": converged}
    return x_ref, u_ref, info
