"""MPC safety filter: condensed QP + batched interior-point solve.

Counterpart of reference core/mpc_filter.py:9-218.  The
reference builds a sparse CVXPY problem over states x[H+1,4], inputs
u[H,2] and per-(t,obstacle) slack variables, and solves it with OSQP.
Here the dynamics equalities (core/mpc_filter.py:83-84) are eliminated by
condensation (X = Phi x0 + Gamma U, see core/dynamics.condensed_dynamics),
leaving a dense inequality-constrained QP in z = [U; slacks]:

  objective (core/mpc_filter.py:61-74,143-144):
      sum_t (x_{t+1}-xref_{t+1})' Q (x_{t+1}-xref_{t+1}) + u_t' R u_t
      + sum_{t,j} (50 s_{t,j} + 50 s_{t,j}^2)
  constraints:
      u box (core/mpc_filter.py:87-91), position box on C x_t for t=1..H
      (core/mpc_filter.py:93-111 -- including the dimension-adaptive trim
      of 4-vector bounds to the 2-dim position), soft halfspace constraints
      h.(C x_t) + g <= s_{t,j}, s >= 0 (core/mpc_filter.py:114-144).

Alignment quirk (replicated): the halfspace computed from obstacle samples
at timestep t constrains the state x_{t+1} (reference core/mpc_filter.py:118
uses safe_halfspaces[t-1] for x_t).

On solver failure the reference falls back to replaying the shifted
previous optimal input sequence (core/mpc_filter.py:180-218); here the
fallback is computed unconditionally inside the jitted program and
selected with `jnp.where`, keeping everything batchable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dynamics import condensed_dynamics_f64, simulate_linear_system
from ..ops.compensated import dot2
from ..ops.qp_ipm_structured import solve_mpc_qp

SLACK_LIN = 50.0   # linear slack penalty   (reference core/mpc_filter.py:143)
SLACK_QUAD = 50.0  # quadratic slack penalty (reference core/mpc_filter.py:144)


@dataclasses.dataclass(frozen=True, eq=False)
class MPCProblem:
    """Static (shape-defining) data of the condensed MPC QP.

    Built once per (A, B, C, Q, R, horizon, n_obstacles) combination and
    passed to the jitted core as a static argument (hashed by identity,
    so reuse the same instance across solves to hit the jit cache).
    """

    A: jax.Array
    B: jax.Array
    C: jax.Array
    Phi: jax.Array      # [H*n, n]
    Gamma: jax.Array    # [H*n, H*m]
    Theta: jax.Array    # [H, p, H*m]  position rows of Gamma
    GtPhi: jax.Array    # [H*m, n]     Gamma' Phi (the gradient's x0 part)
    P: jax.Array        # [nz, nz] constant QP Hessian (x2 convention)
    horizon: int
    n_states: int
    n_inputs: int
    n_outputs: int
    n_obstacles: int
    q_weight: float
    r_weight: float


class MPCResult(NamedTuple):
    x_filtered: jax.Array   # [H+1, n]
    u_filtered: jax.Array   # [H, m]
    slack: jax.Array        # [H, n_obs]
    status: jax.Array       # bool: QP converged (no fallback)
    used_fallback: jax.Array
    objective: jax.Array
    qp_gap: jax.Array
    qp_iterations: jax.Array


def build_mpc_problem(A, B, C, q_weight: float, r_weight: float,
                      horizon: int, n_obstacles: int) -> MPCProblem:
    """Precompute condensed matrices and the constant Hessian.

    Built once per problem shape in float64 on the host and rounded once
    to A's dtype: its products (Gamma'Gamma, C Gamma) ARE the QP data,
    and forming them in float32 leaves several ulps of error in the
    Hessian, which the float32 solve passes on to the controls (about
    half of the error budget against the 1e-4 oracle bound).
    """
    n = A.shape[0]
    m = B.shape[1]
    p = C.shape[0]
    H = horizon
    dtype = A.dtype
    Phi, Gamma = condensed_dynamics_f64(A, B, H)
    C64 = np.asarray(C, np.float64)

    # Position rows: Theta[t] = C @ Gamma[t-block]  -> [H, p, H*m]
    Theta = (np.kron(np.eye(H), C64) @ Gamma).reshape(H, p, H * m)
    n_u = H * m
    n_s = H * n_obstacles
    P = np.zeros((n_u + n_s, n_u + n_s))
    P[:n_u, :n_u] = 2.0 * (q_weight * Gamma.T @ Gamma
                           + r_weight * np.eye(n_u))
    P[n_u:, n_u:] = 2.0 * SLACK_QUAD * np.eye(n_s)

    def cast(x):
        return jnp.asarray(x, dtype)

    return MPCProblem(A, B, C, cast(Phi), cast(Gamma), cast(Theta),
                      cast(Gamma.T @ Phi), cast(P), H, n, m, p,
                      n_obstacles, q_weight, r_weight)


def _trim_bounds(bounds, dim):
    """Reference core/mpc_filter.py:102-108: bounds longer than the
    constrained vector are trimmed to its leading entries.  Returns None
    when no bounds are given (those constraint rows are then omitted from
    the QP entirely, as in reference core/mpc_filter.py:87,93)."""
    if bounds is None:
        return None
    lo, hi = bounds
    lo = np.asarray(lo, dtype=np.float64).reshape(-1)[:dim]
    hi = np.asarray(hi, dtype=np.float64).reshape(-1)[:dim]
    return lo, hi


@functools.partial(jax.jit, static_argnames=("prob", "max_iters",
                                             "has_u_bounds", "has_p_bounds"))
def _filter_core(prob: MPCProblem, x0, x_ref, hs_h, hs_g,
                 u_min, u_max, p_min, p_max, max_iters: int, tol,
                 has_u_bounds: bool = True, has_p_bounds: bool = True,
                 warm=None):
    """Assemble and solve the condensed QP for one instance.

    `has_u_bounds` / `has_p_bounds` are static: absent bounds drop their
    constraint rows from G entirely (different QP shape -> separate
    compile), matching the reference's conditional constraint blocks
    (core/mpc_filter.py:87,93).

    `warm`: optional `(u, s, l1, l2, l3)` iterates of a related solve
    (see ops/qp_ipm_structured.solve_mpc_qp) -- pipeline passes the
    mean-metric solution to seed the cvar/dr_cvar solves.

    Runs at HIGHEST matmul precision: the condensed-data matmuls feed the
    QP right-hand sides, and TF32 products would inject ~1e-3 errors into
    the problem data itself."""
    with jax.default_matmul_precision("highest"):
        return _filter_core_body(prob, x0, x_ref, hs_h, hs_g,
                                 u_min, u_max, p_min, p_max, max_iters, tol,
                                 has_u_bounds, has_p_bounds, warm)


def _filter_core_body(prob, x0, x_ref, hs_h, hs_g,
                      u_min, u_max, p_min, p_max, max_iters, tol,
                      has_u_bounds, has_p_bounds, warm=None):
    H, n, m, p = prob.horizon, prob.n_states, prob.n_inputs, prob.n_outputs
    n_obs = prob.n_obstacles
    n_u = H * m
    n_s = H * n_obs
    dtype = prob.P.dtype

    xr_flat = x_ref[1:H + 1].reshape(-1).astype(dtype)       # [H*n]
    e0 = prob.Phi @ x0.astype(dtype) - xr_flat               # Phi x0 - Xref
    # q_u = 2q Gamma'(Phi x0 - Xref) in compensated arithmetic: its
    # terms are ~100x the result, and a plain float32 product would
    # carry ~1e-4 of rounding into the controls.
    q_u = 2.0 * prob.q_weight * dot2(
        [prob.GtPhi, prob.Gamma.T], [x0.astype(dtype), -xr_flat])

    theta0 = (prob.Phi @ x0.astype(dtype)).reshape(H, n)
    pos0 = theta0 @ prob.C.T                                 # [H, p]

    # Halfspace rows: h_{t,j} . (Theta_t u + pos0_t) + g <= s_{t,j}
    HS_u = jnp.einsum("tjd,tdn->tjn", hs_h.astype(dtype), prob.Theta)
    HS_u = HS_u.reshape(n_s, n_u)
    hs_rhs = (-hs_g.astype(dtype)
              - jnp.einsum("tjd,td->tj", hs_h.astype(dtype), pos0)).reshape(n_s)

    eye_u = jnp.eye(n_u, dtype=dtype)
    Theta_flat = prob.Theta.reshape(H * p, n_u)

    # Box rows (structured solver keeps the slack block separate).
    G_blocks, h_blocks = [], []
    if has_u_bounds:
        G_blocks += [eye_u, -eye_u]
        h_blocks += [jnp.tile(u_max.astype(dtype), H),
                     -jnp.tile(u_min.astype(dtype), H)]
    if has_p_bounds:
        G_blocks += [Theta_flat, -Theta_flat]
        h_blocks += [jnp.tile(p_max.astype(dtype), H) - pos0.reshape(-1),
                     pos0.reshape(-1) - jnp.tile(p_min.astype(dtype), H)]
    if G_blocks:
        G_u = jnp.concatenate(G_blocks, axis=0)
        h1 = jnp.concatenate(h_blocks)
    else:
        G_u = jnp.zeros((0, n_u), dtype)
        h1 = jnp.zeros((0,), dtype)

    P_uu = prob.P[:n_u, :n_u]
    # Both box families present -> G has the [I; -I; Theta; -Theta]
    # layout the solver can exploit structurally (halves the Schur
    # assembly FLOPs; see solve_mpc_qp's box_theta doc).
    box_theta = Theta_flat if (has_u_bounds and has_p_bounds) else None
    sol = solve_mpc_qp(P_uu, q_u, G_u, h1, HS_u, hs_rhs,
                       2.0 * SLACK_QUAD, SLACK_LIN,
                       max_iters=max_iters, tol=tol, warm=warm,
                       box_theta=box_theta)

    u_opt = sol.u.reshape(H, m)
    slack = sol.s.reshape(H, n_obs)
    # Constant term dropped during condensation, so reported objective
    # matches the reference's problem.value (core/mpc_filter.py:165).
    const = prob.q_weight * jnp.dot(e0, e0)
    objective = sol.obj + const
    return u_opt, slack, sol, objective


@functools.partial(jax.jit, static_argnames=("prob", "max_iters", "chunk"))
def filter_core_batched(prob: MPCProblem, x0_b, x_ref_b, hs_h_b, hs_g_b,
                        u_min, u_max, p_min, p_max, max_iters: int, tol,
                        chunk: int = 512):
    """Batched `_filter_core` with the batch split into independent
    `chunk`-sized while_loops.

    Under one flat vmap the IPM's shared `lax.while_loop` runs until the
    SLOWEST instance converges, and E[max iterations] grows with batch.
    `lax.map` with batch_size=chunk gives each chunk its own loop:
    early-converging chunks retire instead of idling behind global
    stragglers.  The chunk of 512 has not been measured on the GPU
    yet.  Any batch size works (lax.map handles the remainder chunk
    natively).  Returns (u [B,H,m], slack [B,H,n_obs], MPCQPSolution
    batch, obj [B]).
    """
    B = x0_b.shape[0]

    def solve_one(args):
        a, b, c, d = args
        return _filter_core(prob, a, b, c, d, u_min, u_max,
                            p_min, p_max, max_iters, tol)

    data = (x0_b, x_ref_b, hs_h_b, hs_g_b)
    if B <= chunk:
        return jax.vmap(solve_one)(data)
    return jax.lax.map(solve_one, data, batch_size=chunk)


def filter_trajectory(prob: MPCProblem, x0, x_ref, u_ref, hs_h, hs_g,
                      input_bounds=None, position_bounds=None,
                      last_optimal_u=None, has_last=False,
                      max_iters: int = 60, tol: float | None = None
                      ) -> MPCResult:
    """Filter a reference trajectory (reference core/mpc_filter.py:40-178).

    Args:
      prob: MPCProblem from `build_mpc_problem`.
      x0: [n] initial state.
      x_ref: [H+1, n] reference states; u_ref: [H, m] reference inputs.
      hs_h: [H, n_obs, 2] halfspace normals computed at timestep t
            (constraining x_{t+1}); hs_g: [H, n_obs] offsets.
      input_bounds / position_bounds: (min, max) pairs or None.  Bounds
        longer than the constrained vector are trimmed, replicating
        reference core/mpc_filter.py:102-108 (the `state_bounds[:2]`
        call-site quirk of reference main.py:112).
      last_optimal_u / has_last: previous optimal inputs for the fallback
        (functional counterpart of `self.last_optimal_u`,
        core/mpc_filter.py:37,157).
    """
    H, m = prob.horizon, prob.n_inputs
    ub = _trim_bounds(input_bounds, m)
    pb = _trim_bounds(position_bounds, prob.n_outputs)
    zero_u = jnp.zeros((m,))
    zero_p = jnp.zeros((prob.n_outputs,))
    u_min, u_max = (jnp.asarray(ub[0]), jnp.asarray(ub[1])) if ub else (zero_u, zero_u)
    p_min, p_max = (jnp.asarray(pb[0]), jnp.asarray(pb[1])) if pb else (zero_p, zero_p)

    u_opt, slack, sol, objective = _filter_core(
        prob, x0, x_ref, hs_h, hs_g, u_min, u_max, p_min, p_max,
        max_iters, tol, has_u_bounds=ub is not None,
        has_p_bounds=pb is not None)

    # Fallback (reference core/mpc_filter.py:180-218): shift the previous
    # optimal sequence by one step, pad the tail with u_ref; if no previous
    # solution exists, replay u_ref.
    if last_optimal_u is None:
        last_optimal_u = jnp.zeros_like(u_ref)
        has_last = False
    shifted = jnp.concatenate([last_optimal_u[1:], u_ref[H - 1:H]], axis=0)
    u_fb = jnp.where(jnp.asarray(has_last), shifted, u_ref)

    use_fallback = ~sol.converged
    u_final = jnp.where(use_fallback, u_fb, u_opt)
    x_final, _ = simulate_linear_system(x0.astype(u_final.dtype), u_final,
                                        prob.A, prob.B, prob.C)
    return MPCResult(
        x_filtered=x_final,
        u_filtered=u_final,
        slack=slack,
        status=sol.converged,
        used_fallback=use_fallback,
        objective=objective,
        qp_gap=sol.gap,
        qp_iterations=sol.iterations,
    )
