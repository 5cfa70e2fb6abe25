"""Batched dense primal-dual interior-point QP solver.

Solves   min_z  0.5 z'Pz + q'z   s.t.  G z <= h
with a Mehrotra predictor-corrector method and a FIXED iteration count so
the whole solve jit-compiles to one XLA program and `vmap`s over
thousands of instances (the batched replacement for the per-instance
CVXPY/OSQP solves of reference core/mpc_filter.py:151).

Shapes (single instance; vmap for batches):
  P [n, n] (sym. positive definite), q [n], G [m, n], h [m].

The per-iteration cost is one n x n Cholesky factorization plus a few
G-matvecs; batched instances turn these into batched matrix products.
The problems this engine produces are always feasible (halfspace
constraints are soft via slack variables), so no infeasibility
certificate is needed -- non-convergence is reported through
`QPSolution.converged` and handled by the caller's fallback path
(mirroring reference core/mpc_filter.py:166-218).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class QPSolution(NamedTuple):
    z: jax.Array           # [n] primal solution
    lam: jax.Array         # [m] dual multipliers for Gz <= h
    obj: jax.Array         # [] objective value 0.5 z'Pz + q'z
    gap: jax.Array         # [] final complementarity measure mu
    prim_res: jax.Array    # [] ||max(Gz - h, 0)||_inf
    dual_res: jax.Array    # [] ||Pz + q + G'lam||_inf
    converged: jax.Array   # [] bool: achieved merit < 10*tol (see solve_qp)
    iterations: jax.Array  # [] int32 (iterations until converged, else max)
    merit: jax.Array       # [] achieved scaled KKT merit, for callers that
                           #    want their own acceptance threshold


def _pos_step(v, dv, frac):
    """Largest alpha <= 1 with v + alpha*dv >= (1-frac)*... (standard
    fraction-to-boundary rule): alpha = frac * min over dv<0 of -v/dv."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, frac * jnp.min(ratio))


@functools.partial(jax.jit, static_argnames=("max_iters",))
def solve_qp(P, q, G, h, max_iters: int = 60, tol: float | None = None,
             reg: float = 0.0):
    """Primal-dual IPM solve of min 0.5 z'Pz + q'z s.t. Gz <= h.

    `tol` is the iteration target on the scaled KKT merit
    (complementarity + violation + dual residual, scaled by max|q|);
    iterations stop early on convergence, stagnation, or breakdown.

    ACCEPTANCE CONTRACT: `QPSolution.converged` is True when the best
    achieved merit is < 10*tol -- the loop aims for `tol` but in float32
    the achievable merit floor on ill-scaled data can sit slightly above
    a tight target, and a 10x-looser iterate is still ~3x tighter than
    the reference's OSQP eps=1e-3 defaults (CVXPY default solver,
    reference core/mpc_filter.py:151).  Callers needing a different
    threshold should test `QPSolution.merit` themselves.
    """
    dtype = P.dtype
    n = P.shape[0]
    m = G.shape[0]
    if reg == 0.0:
        reg = 1e-10 if dtype == jnp.float64 else 1e-7
    if tol is None:
        tol = 1e-9 if dtype == jnp.float64 else 3e-5
    return _solve_qp_hp(P, q, G, h, max_iters, tol, reg)


def _solve_qp_hp(P, q, G, h, max_iters, tol, reg):
    """IPM body, run at HIGHEST matmul precision: a TF32 product (the
    GPU's default f32 precision may use it) has a ~1e-3 error floor that
    stalls the Newton iteration; full f32 restores ~1e-6."""
    with jax.default_matmul_precision("highest"):
        return _solve_qp_body(P, q, G, h, max_iters, tol, reg)


def _solve_qp_body(P, q, G, h, max_iters, tol, reg):
    dtype = P.dtype
    n = P.shape[0]
    m = G.shape[0]

    # Row equilibration: scale each constraint row to unit inf-norm so
    # wildly different constraint scales (e.g. +-1e6 stand-in boxes next
    # to unit halfspace rows) don't destroy the barrier's centrality.
    # G z <= h  <=>  (G/r) z <= h/r with dual lam_orig = lam_scaled / r.
    row_scale = jnp.maximum(jnp.max(jnp.abs(G), axis=1),
                            jnp.asarray(1e-8, dtype))
    G = G / row_scale[:, None]
    h = h / row_scale

    q_scale = jnp.maximum(jnp.max(jnp.abs(q)), 1.0)
    big = jnp.asarray(1e30, dtype)

    z = jnp.zeros((n,), dtype)
    w = jnp.maximum(h, 1.0)         # slack: Gz + w = h  => r_prim tracked
    # Perfectly centered start: lam_i * w_i == 1 for every constraint, so
    # widely different slack scales (e.g. loose box rows with huge rhs)
    # don't wreck the barrier's centrality at iteration 0.
    lam = jnp.clip(1.0 / w, 1e-6, 1e6)
    eye = jnp.eye(n, dtype=dtype)

    def merit_of(z, w, lam):
        """Scaled KKT merit: complementarity + true violation + dual res.

        Uses max(Gz - h, 0) (the actual constraint violation) rather than
        |Gz + w - h|: near degenerate constraints w tracks h - Gz noisily
        while the violation itself stays ~0."""
        mu = jnp.dot(lam, w) / m
        viol = jnp.max(jnp.maximum(G @ z - h, 0.0))
        rd = jnp.max(jnp.abs(P @ z + q + G.T @ lam))
        return (mu + viol + rd) / q_scale, mu, viol, rd

    def cond(state):
        _, _, _, _, done, _, iters = state
        return jnp.logical_not(done) & (iters < max_iters)

    def body(state):
        z, w, lam, best, done, stall, iters = state
        best_merit, bz, bw, blam = best

        r_dual = P @ z + q + G.T @ lam
        r_prim = G @ z + w - h
        mu = jnp.dot(lam, w) / m

        # Track the best iterate seen: late-stage steps at mu ~ eps are
        # noise-dominated (degenerate constraints drive w and lam to zero
        # together) and can transiently degrade the iterates.
        merit, _, _, _ = merit_of(z, w, lam)
        better = merit < best_merit
        # Stagnation / breakdown exits (same policy as the structured
        # solver, qp_ipm_structured._solve_body): count iterations without
        # a material (0.5% relative) improvement of the best merit; a
        # non-finite merit means the iterate broke down (tiny-mu float32
        # Cholesky) and the tracked best iterate is the answer.  Without
        # these, one stalling lane drags a whole vmapped batch to
        # max_iters.
        improved = merit < best_merit * 0.995
        stall = jnp.where(improved, 0, stall + 1)
        broke = ~jnp.isfinite(merit)
        best_merit = jnp.where(better, merit, best_merit)
        bz = jnp.where(better, z, bz)
        bw = jnp.where(better, w, bw)
        blam = jnp.where(better, lam, blam)

        d = jnp.clip(lam / w, 1e-10, 1e10)
        M = P + (G.T * d) @ G + reg * eye
        chol = jax.scipy.linalg.cho_factor(M)

        def newton(r_cent):
            rhs = -r_dual - G.T @ (d * r_prim - r_cent / w)
            dz = jax.scipy.linalg.cho_solve(chol, rhs)
            dlam = d * (G @ dz + r_prim) - r_cent / w
            dw = -(r_cent + w * dlam) / lam
            return dz, dlam, dw

        # Affine (predictor) direction.
        dz_a, dlam_a, dw_a = newton(lam * w)
        a_p = _pos_step(w, dw_a, 1.0)
        a_d = _pos_step(lam, dlam_a, 1.0)
        mu_aff = jnp.dot(lam + a_d * dlam_a, w + a_p * dw_a) / m
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        # Corrector direction.
        r_cent = lam * w + dlam_a * dw_a - sigma * mu
        dz, dlam, dw = newton(r_cent)
        a_p = _pos_step(w, dw, 0.99)
        a_d = _pos_step(lam, dlam, 0.99)

        conv = best_merit < tol
        done_n = done | conv | broke | (stall >= 10)
        # Freeze once converged: the detecting iteration must not step.
        z_n = jnp.where(done_n, z, z + a_p * dz)
        w_n = jnp.where(done_n, w, w + a_p * dw)
        lam_n = jnp.where(done_n, lam, lam + a_d * dlam)
        iters_n = jnp.where(done_n, iters, iters + 1)
        return (z_n, w_n, lam_n, (best_merit, bz, bw, blam), done_n,
                stall, iters_n)

    init = (z, w, lam, (big, z, w, lam), jnp.asarray(False),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    z, w, lam, best, done, stall, iters = jax.lax.while_loop(
        cond, body, init)

    # Final candidate may beat the tracked best (the loop checks at entry).
    merit, _, _, _ = merit_of(z, w, lam)
    best_merit, bz, bw, blam = best
    better = merit < best_merit
    best_merit = jnp.where(better, merit, best_merit)
    z = jnp.where(better, z, bz)
    w = jnp.where(better, w, bw)
    lam = jnp.where(better, lam, blam)

    obj = 0.5 * z @ (P @ z) + q @ z
    gap = jnp.dot(lam, w) / m
    prim_res = jnp.max(jnp.maximum(G @ z - h, 0.0))
    dual_res = jnp.max(jnp.abs(P @ z + q + G.T @ lam))
    # Acceptance is 10x the iteration target, matching the structured
    # solver (qp_ipm_structured.py): the loop aims for `tol` but an
    # iterate within 10*tol is still far tighter than the reference's
    # OSQP eps=1e-3 defaults.
    converged = best_merit < 10.0 * tol
    lam_orig = lam / row_scale  # duals in the caller's (unscaled) geometry
    return QPSolution(z, lam_orig, obj, gap, prim_res, dual_res, converged,
                      iters, best_merit)


def solve_qp_batched(P, q, G, h, max_iters: int = 60,
                     tol: float | None = None):
    """vmap of `solve_qp` over a leading batch axis of every argument."""
    fn = functools.partial(solve_qp, max_iters=max_iters, tol=tol)
    return jax.vmap(fn)(P, q, G, h)
