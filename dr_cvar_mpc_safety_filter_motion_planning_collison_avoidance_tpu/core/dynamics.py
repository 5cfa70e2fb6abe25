"""Discrete-time LTI dynamics (double / single integrator) and rollouts.

Counterpart of reference core/dynamics.py:7-83.  Rollouts use
`lax.scan` instead of Python loops so they jit to a single fused program
and batch with `vmap`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def create_double_integrator_matrices(dt: float, dim: int = 2, dtype=jnp.float32):
    """State-space matrices of a discrete double integrator.

    State [p, v] in R^{2*dim}; reference core/dynamics.py:7-33.
    Returns (A, B, C) with A: [2d,2d], B: [2d,d], C: [d,2d].
    """
    eye = np.eye(dim)
    zeros = np.zeros((dim, dim))
    A = np.block([[eye, dt * eye], [zeros, eye]])
    B = np.block([[0.5 * dt**2 * eye], [dt * eye]])
    C = np.block([eye, zeros])
    return jnp.asarray(A, dtype), jnp.asarray(B, dtype), jnp.asarray(C, dtype)


def create_single_integrator_matrices(dt: float, dim: int = 2, dtype=jnp.float32):
    """Single-integrator matrices (reference core/dynamics.py:35-55)."""
    eye = np.eye(dim)
    return (
        jnp.asarray(eye, dtype),
        jnp.asarray(dt * eye, dtype),
        jnp.asarray(eye, dtype),
    )


@functools.partial(jax.jit, static_argnames=())
def simulate_linear_system(x0, u_sequence, A, B, C):
    """Roll out x_{t+1} = A x_t + B u_t and y_t = C x_t.

    Reference core/dynamics.py:57-83 (serial Python loop) rebuilt as a
    `lax.scan`.  Shapes: x0 [n], u_sequence [T, m] -> ([T+1, n], [T+1, p]).

    Runs at HIGHEST matmul precision: a default-precision f32 product
    may run in TF32 on the GPU (~1e-3 relative error, about three
    decimal digits) PER STEP of the recursion, which compounds over a
    horizon-length rollout far above the <1e-4 end-to-end
    control/distance contract.  The matrices are 4x4; the cost of full
    precision is irrelevant.
    """
    with jax.default_matmul_precision("highest"):
        def step(x, u):
            x_next = A @ x + B @ u
            return x_next, x_next

        _, xs = jax.lax.scan(step, x0, u_sequence)
        x_sequence = jnp.concatenate([x0[None, :], xs], axis=0)
        y_sequence = x_sequence @ C.T
    return x_sequence, y_sequence


def rollout_positions(start_pos, velocity, n_steps: int, dt: float):
    """Constant-velocity position rollout: start + t*dt*velocity.

    Closed form of a single-integrator rollout with constant input
    (what reference simulation/obstacles.py:7-41 computes with a loop).
    Returns positions [n_steps+1, dim].
    """
    t = jnp.arange(n_steps + 1, dtype=start_pos.dtype)[:, None]
    return start_pos[None, :] + t * dt * velocity[None, :]


def condensed_dynamics_f64(A, B, horizon: int):
    """`condensed_dynamics` as float64 NumPy arrays (host-side builders
    that form further products before rounding)."""
    A_np = np.asarray(A, dtype=np.float64)
    B_np = np.asarray(B, dtype=np.float64)
    n, m = B_np.shape
    H = horizon

    powers = [np.eye(n)]
    for _ in range(H):
        powers.append(A_np @ powers[-1])

    Phi = np.concatenate([powers[t] for t in range(1, H + 1)], axis=0)
    Gamma = np.zeros((H * n, H * m))
    for t in range(1, H + 1):
        for j in range(t):
            Gamma[(t - 1) * n : t * n, j * m : (j + 1) * m] = powers[t - 1 - j] @ B_np
    return Phi, Gamma


def condensed_dynamics(A, B, horizon: int):
    """Condensed prediction matrices for X = Phi x0 + Gamma U.

    X = [x_1; ...; x_H] stacked states, U = [u_0; ...; u_{H-1}] stacked
    inputs.  Phi: [H*n, n], Gamma: [H*n, H*m] block-lower-triangular with
    Gamma[t, j] = A^{t-1-j} B for j < t.  Used to eliminate the dynamics
    equality constraints of the MPC QP (reference core/mpc_filter.py:83-84)
    so the QP is solved in input space only.

    Computed in float64 on host (numpy) for accuracy, cast to A.dtype.
    """
    Phi, Gamma = condensed_dynamics_f64(A, B, horizon)
    return jnp.asarray(Phi, A.dtype), jnp.asarray(Gamma, A.dtype)
