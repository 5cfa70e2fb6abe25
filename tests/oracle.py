"""Independent NumPy/SciPy oracles for golden tests.

These implement the reference's MATH CONTRACT (the convex programs of
reference core/risk_metrics.py:84-265 and the MPC QP of
core/mpc_filter.py:40-178) with generic scipy solvers -- a code path
fully independent of both the reference's CVXPY build and the
engine's closed forms / IPM, so agreement is meaningful evidence.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def cvar_halfspace_lp(s, alpha, delta, r_tilde):
    """Solve the CVaR halfspace program with scipy linprog.

    min g  s.t.  eta_i >= -s_i - g + r~ - tau,  eta >= 0,
                 tau + 1/(alpha N) sum eta <= delta
    Variables: [g, tau, eta_1..eta_N].  (Reference core/risk_metrics.py:199-211.)
    """
    n = len(s)
    c = np.zeros(n + 2)
    c[0] = 1.0
    # -g - tau - eta_i <= s_i - r~   (from eta_i >= -s_i - g + r~ - tau)
    A1 = np.zeros((n, n + 2))
    A1[:, 0] = -1.0
    A1[:, 1] = -1.0
    A1[np.arange(n), 2 + np.arange(n)] = -1.0
    b1 = s - r_tilde
    # tau + 1/(alpha n) sum eta <= delta
    A2 = np.zeros((1, n + 2))
    A2[0, 1] = 1.0
    A2[0, 2:] = 1.0 / (alpha * n)
    b2 = np.array([delta])
    A = np.vstack([A1, A2])
    b = np.concatenate([b1, b2])
    bounds = [(None, None), (None, None)] + [(0.0, None)] * n
    res = linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
    assert res.status == 0, res.message
    return res.x[0]


def dr_cvar_halfspace_lp(s, alpha, delta, epsilon, r_tilde):
    """Solve the DR-CVaR halfspace program with scipy linprog.

    min g s.t. lambda*eps + 1/N sum eta <= delta; lambda >= 1/alpha;
    for each i and k in {1,2}:
        a_k s_i + b_k (g - r~) + c_k tau <= eta_i
    with a = b = [-1/alpha, 0], c = [1 - 1/alpha, 1]
    (reference core/risk_metrics.py:105-125).
    Variables: [g, tau, lam, eta_1..eta_N].
    """
    n = len(s)
    nv = n + 3
    c = np.zeros(nv)
    c[0] = 1.0
    rows, bs = [], []
    # lambda*eps + 1/N sum eta <= delta
    r0 = np.zeros(nv)
    r0[2] = epsilon
    r0[3:] = 1.0 / n
    rows.append(r0)
    bs.append(delta)
    # k=1: (-1/a) s_i + (-1/a)(g - r~) + (1 - 1/a) tau - eta_i <= 0
    inv_a = 1.0 / alpha
    for i in range(n):
        r = np.zeros(nv)
        r[0] = -inv_a
        r[1] = 1.0 - inv_a
        r[3 + i] = -1.0
        rows.append(r)
        bs.append(inv_a * s[i] - inv_a * r_tilde)
        # k=2: tau - eta_i <= 0
        r = np.zeros(nv)
        r[1] = 1.0
        r[3 + i] = -1.0
        rows.append(r)
        bs.append(0.0)
    # 1/alpha <= lambda
    r = np.zeros(nv)
    r[2] = -1.0
    rows.append(r)
    bs.append(-inv_a)
    bounds = [(None, None), (None, None), (0.0, None)] + [(None, None)] * n
    res = linprog(c, A_ub=np.array(rows), b_ub=np.array(bs), bounds=bounds,
                  method="highs")
    assert res.status == 0, res.message
    return res.x[0]


def empirical_cvar_lp(x, alpha):
    """min_tau tau + 1/(alpha N) sum (x_i - tau)_+ via linprog.

    Variables: [tau, eta_1..eta_N].
    """
    n = len(x)
    c = np.zeros(n + 1)
    c[0] = 1.0
    c[1:] = 1.0 / (alpha * n)
    A = np.zeros((n, n + 1))
    A[:, 0] = -1.0
    A[np.arange(n), 1 + np.arange(n)] = -1.0
    res = linprog(c, A_ub=A, b_ub=-x,
                  bounds=[(None, None)] + [(0.0, None)] * n, method="highs")
    assert res.status == 0, res.message
    return res.fun


def mpc_qp_oracle(A, B, C, q_weight, r_weight, horizon, x0, x_ref,
                  hs_h, hs_g, u_min, u_max, p_min, p_max,
                  slack_lin=50.0, slack_quad=50.0):
    """Dense active-set-free solve of the reference MPC QP via its KKT
    system, exploiting that the problem is strictly convex.

    Builds the SAME condensed QP as the engine but solves it with a
    totally different method: scipy trust-constr on the full nonlinear
    programming form, started from zero.  Returns (u [H,m], slacks).
    """
    from scipy.optimize import LinearConstraint, minimize

    n, m = B.shape
    H = horizon
    n_obs = hs_h.shape[1]

    powers = [np.eye(n)]
    for _ in range(H):
        powers.append(A @ powers[-1])
    Phi = np.concatenate(powers[1:], axis=0)
    Gamma = np.zeros((H * n, H * m))
    for t in range(1, H + 1):
        for j in range(t):
            Gamma[(t - 1) * n:t * n, j * m:(j + 1) * m] = powers[t - 1 - j] @ B

    xr = x_ref[1:].reshape(-1)
    e0 = Phi @ x0 - xr
    n_u, n_s = H * m, H * n_obs
    P = np.zeros((n_u + n_s, n_u + n_s))
    P[:n_u, :n_u] = 2 * (q_weight * Gamma.T @ Gamma + r_weight * np.eye(n_u))
    P[n_u:, n_u:] = 2 * slack_quad * np.eye(n_s)
    q = np.concatenate([2 * q_weight * Gamma.T @ e0,
                        slack_lin * np.ones(n_s)])

    Cbar = np.kron(np.eye(H), C)
    Theta = (Cbar @ Gamma).reshape(H, C.shape[0], n_u)
    pos0 = (Phi @ x0).reshape(H, n) @ C.T

    G_rows, h_vals = [], []
    eye_u = np.eye(n_u)
    zero_us = np.zeros((n_u, n_s))
    G_rows.append(np.hstack([eye_u, zero_us]))
    h_vals.append(np.tile(u_max, H))
    G_rows.append(np.hstack([-eye_u, zero_us]))
    h_vals.append(-np.tile(u_min, H))
    Theta_flat = Theta.reshape(-1, n_u)
    zero_ps = np.zeros((Theta_flat.shape[0], n_s))
    G_rows.append(np.hstack([Theta_flat, zero_ps]))
    h_vals.append(np.tile(p_max, H) - pos0.reshape(-1))
    G_rows.append(np.hstack([-Theta_flat, zero_ps]))
    h_vals.append(pos0.reshape(-1) - np.tile(p_min, H))
    HS_u = np.einsum("tjd,tdn->tjn", hs_h, Theta).reshape(n_s, n_u)
    G_rows.append(np.hstack([HS_u, -np.eye(n_s)]))
    h_vals.append((-hs_g - np.einsum("tjd,td->tj", hs_h, pos0)).reshape(-1))
    G_rows.append(np.hstack([np.zeros((n_s, n_u)), -np.eye(n_s)]))
    h_vals.append(np.zeros(n_s))
    G = np.vstack(G_rows)
    h = np.concatenate(h_vals)

    res = minimize(
        lambda z: 0.5 * z @ P @ z + q @ z,
        np.zeros(n_u + n_s),
        jac=lambda z: P @ z + q,
        hess=lambda z: P,
        constraints=[LinearConstraint(G, -np.inf, h)],
        method="trust-constr",
        options={"gtol": 1e-12, "xtol": 1e-14, "maxiter": 3000},
    )
    z = res.x
    obj_const = q_weight * e0 @ e0
    return (z[:n_u].reshape(H, m), z[n_u:].reshape(H, n_obs),
            res.fun + obj_const)
