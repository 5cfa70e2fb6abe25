"""Structure-exploiting IPM for the MPC safety-filter QP.

The condensed MPC QP (models/mpc_filter.py) has the form

  min_u,s  0.5 u'P_uu u + q_u'u + 0.5 s'(p_ss I)s + q_s's
  s.t.     G_u u <= h1          (input + position boxes, m1 rows)
           A u - s <= b         (soft halfspace rows,    m2 rows)
           -s <= 0              (slack nonnegativity,    m2 rows)

The generic solver (ops/qp_ipm.py) factorizes the full
(n_u + m2) x (n_u + m2) normal matrix each iteration.  Here the slack
block is eliminated analytically: its contribution to the Newton system
is DIAGONAL (m_ss = p_ss + d2 + d3), so a Schur complement reduces each
iteration to ONE n_u x n_u Cholesky -- for the multi-obstacle MPC that
is 60x60 instead of 150x150 (~15x fewer factorization FLOPs) and far
less memory traffic per iteration.

Same Mehrotra predictor-corrector, centered start, best-iterate
tracking, and merit-based convergence as the generic solver; verified
against it in tests/test_qp_structured.py.

Termination is two-tier: iteration stops when the best merit reaches
`tol` OR the best merit has stopped improving (stagnation / non-finite
breakdown — in float32 the achievable merit floor on ill-scaled data can
sit slightly above a tight target), and the `converged` flag accepts
`best_merit < 10*tol`.  For reference-parity context, the reference
solves this QP with OSQP at eps_abs = eps_rel = 1e-3 (CVXPY defaults,
reference core/mpc_filter.py:151), so the f32 acceptance threshold
3e-4 is still ~3x tighter than the baseline solver's.  Early exit
matters for throughput: under `vmap`, `lax.while_loop` runs until every
lane is done, so one stagnating lane would otherwise drag the whole
batch to `max_iters`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .compensated import dot2


def _factor(S):
    """Lower Cholesky factor.  Under `vmap` XLA batches it (cuSOLVER on
    the GPU); the named scope lets a profiler trace attribute its time."""
    with jax.named_scope("ipm_factor"):
        return jax.lax.linalg.cholesky(S)


def _solve(L, r):
    """Solve L L' x = r (both triangular solves), traced as `ipm_solve`."""
    with jax.named_scope("ipm_solve"):
        return jax.scipy.linalg.cho_solve((L, True), r)


class MPCQPSolution(NamedTuple):
    u: jax.Array           # [n_u]
    s: jax.Array           # [m2] slack variables
    obj: jax.Array
    gap: jax.Array         # complementarity from TRUE slacks (h - G z)
    prim_res: jax.Array
    dual_res: jax.Array
    converged: jax.Array   # achieved merit < 10*tol (see solve_mpc_qp)
    iterations: jax.Array
    merit: jax.Array       # achieved scaled KKT merit (callers may apply
                           # their own acceptance threshold)
    mults: tuple           # (l1 [m1], l2 [m2], l3 [m2]) dual iterates --
                           # feed back as `warm` to seed a related solve


def _pos_step(v, dv, frac):
    if v.shape[0] == 0:  # empty constraint block (e.g. no boxes)
        return jnp.asarray(1.0, v.dtype)
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, frac * jnp.min(ratio))


@functools.partial(jax.jit, static_argnames=("max_iters", "polish",
                                             "linsolve"))
def solve_mpc_qp(P_uu, q_u, G_u, h1, A, b, p_ss, q_s,
                 max_iters: int = 60, tol: float | None = None,
                 reg: float = 0.0, polish: bool = True,
                 linsolve: str = "chol", warm=None, box_theta=None):
    """Solve the slack-structured QP above.

    Shapes: P_uu [n,n], q_u [n], G_u [m1,n], h1 [m1], A [m2,n], b [m2],
    p_ss [] or [m2] (diagonal quadratic slack weight), q_s [] or [m2].

    `polish=True` appends an active-set Newton polish (see `_polish`)
    that takes the float32 iterate from the IPM's merit floor (~1e-4
    relative) down to linear-solve accuracy (~1e-6) -- needed to meet
    the <1e-4 end-to-end control-deviation target in float32.

    `warm` (optional): a `(u0, s0, l1, l2, l3)` tuple -- typically the
    iterates (`sol.u`, `sol.s`, `*sol.mults`) of a RELATED solve (same
    shapes, nearby data: another risk metric's QP, the previous
    receding-horizon step) -- used as the interior-point start after
    interiority shifts (slacks/multipliers floored at 1e-2).  Purely a
    convergence accelerator: the merit-based termination, best-iterate
    tracking, polish and acceptance thresholds are identical, so a bad
    seed costs iterations, never accuracy.

    `box_theta` (optional): when `G_u` has the MPC box layout
    `[I; -I; T; -T]` (input boxes as identity rows, position boxes as
    +-T rows), pass T ([hp, n]) here.  Every per-iteration product with
    G_u then exploits the structure -- (G'.d)G collapses to
    diag(da+db) + (T'.(dc+dd))T, matvecs to one T product -- cutting
    the Schur-assembly FLOPs (the iteration's dominant matmul) roughly
    in half.  `G_u`/`h1` must still be passed (the one-shot active-set
    polish gathers dense rows); results are identical up to f32
    summation order.

    `linsolve` picks how the per-iteration Newton systems are solved:
      * "chol": cho_factor once, two single-RHS cho_solve calls
        (predictor + corrector).  Best serially, but under `vmap` each
        batched single-RHS triangular solve is a 60-step sequential
        chain of tiny ops.
      * "inv": cho_factor once, then S^-1 = cho_solve(chol, I) -- ONE
        multi-RHS triangular solve (n RHS at once, matmul-shaped) -- and
        both Newton solves become plain matvecs.  Same factorization
        accuracy; the extra inverse-apply rounding is absorbed by the
        IPM's best-iterate tracking + the active-set polish.
    """
    dtype = P_uu.dtype
    if reg == 0.0:
        reg = 1e-10 if dtype == jnp.float64 else 1e-7
    if tol is None:
        tol = 1e-9 if dtype == jnp.float64 else 3e-5
    return _solve_body(P_uu, q_u, G_u, h1, A, b, p_ss, q_s,
                       max_iters, tol, reg, polish, linsolve, warm,
                       box_theta)


# Most equality-constrained solves in one polish: the first on the
# active set read off the IPM iterate, then corrections (see _polish).
_POLISH_ROUNDS = 6


def _polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
            u, s, l1, l2, l3, w1, w2, w3):
    """Active-set Newton polish of a near-optimal IPM iterate.

    The soft-slack structure admits an analytic elimination of every
    slack case once the active set is known:

      * soft row j ACTIVE in `A u - s <= b` but s_j > 0 ("penalized"):
        s-stationarity gives nu2_j = p_ss s_j + q_s with
        s_j = A_j u - b_j, i.e. the row acts on u as an EXACT quadratic
        + linear penalty -- fold p_ss into the Hessian.
      * soft row ACTIVE with s_j = 0 ("equality"): A_j u = b_j with a
        free multiplier.
      * s_j = 0 only (row slack): contributes nothing to u.

    What remains is an equality-constrained QP in u (`_polish_solve`).
    The first active set is classified by l > w at the IPM's merit
    floor.  In float32 that floor can leave a few rows ambiguous (l/w
    within a factor of ~2), so the set is then corrected from each
    solve, primal-dual active-set style, until it stops changing (at
    most `_POLISH_ROUNDS` solves): an active row whose multiplier has
    the wrong sign leaves, an inactive row whose constraint is violated
    enters, and a soft row moves between the equality and penalized
    cases by its multiplier and residual.

    The polished iterate replaces the IPM one only when its merit is
    lower.
    """
    dtype = P_uu.dtype
    n = P_uu.shape[0]
    m1 = G_u.shape[0]
    l_all = jnp.concatenate([l1, l2])

    def corrected(sets, u_p, nu):
        a1, m_pen, m_eq = sets
        r2 = A @ u_p - b
        nu2 = nu[m1:]
        return (jnp.where(a1, nu[:m1] > 0, G_u @ u_p - h1 > 0),
                jnp.where(m_pen, r2 > 0, m_eq & (nu2 > q_s)),
                jnp.where(m_pen, r2 <= 0,
                          jnp.where(m_eq, (nu2 >= 0) & (nu2 <= q_s),
                                    r2 > 0)))

    def cond(state):
        k, _, _, _, _, changed = state
        return (k < _POLISH_ROUNDS) & changed

    def body(state):
        k, sets, _, _, _, _ = state
        u_p, nu = _polish_solve(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
                                *sets, l_all)
        nxt = corrected(sets, u_p, nu)
        changed = jnp.any(jnp.concatenate(
            [x != y for x, y in zip(nxt, sets)]))
        return k + 1, nxt, sets, u_p, nu, changed

    # Active box rows, soft rows active with s > 0 (exact penalty) and
    # soft rows active with s = 0 (equality on u).
    a2, a3 = l2 > w2, l3 > w3
    sets = (l1 > w1, a2 & ~a3, a2 & a3)
    init = (jnp.asarray(0, jnp.int32), sets, sets,
            jnp.zeros((n,), dtype), jnp.zeros_like(l_all),
            jnp.asarray(True))
    _, _, (a1, m_pen, m_eq), u_p, nu, _ = jax.lax.while_loop(
        cond, body, init)

    Au = A @ u_p
    s_p = jnp.maximum(jnp.where(m_pen, Au - b, 0.0), 0.0)
    l1_p = jnp.where(a1, jnp.maximum(nu[:m1], 0.0), 0.0)
    nu2 = nu[m1:]
    l2_p = jnp.where(m_pen, p_ss * s_p + q_s,
                     jnp.where(m_eq, jnp.clip(nu2, 0.0, q_s), 0.0))
    l3_p = jnp.maximum(p_ss * s_p + q_s - l2_p, 0.0)
    tiny = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)
    w1_p = jnp.maximum(h1 - G_u @ u_p, tiny)
    w2_p = jnp.maximum(b - Au + s_p, tiny)
    w3_p = jnp.maximum(s_p, tiny)
    # Zero the complementarity products on the active rows (they are
    # equalities now; residual w is solve noise, not a gap).
    w1_p = jnp.where(a1, tiny, w1_p)
    w2_p = jnp.where(m_pen | m_eq, tiny, w2_p)
    w3_p = jnp.where(~m_pen, tiny, w3_p)
    return u_p, s_p, l1_p, l2_p, l3_p, w1_p, w2_p, w3_p


def _polish_solve(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
                  a1, m_pen, m_eq, l_all):
    """u and the row multipliers nu [m1 + m2] of the equality-constrained
    QP that active set (a1, m_pen, m_eq) leaves (see `_polish`).

    KKT solved by a Schur complement over the ACTIVE rows of [G_u; A].
    At a nondegenerate optimum at most n (=60) constraints can be
    active, so instead of factorizing the dense (m1+2m2)-row Schur matrix
    (330x330 at the multi-obstacle shape), the <=64 highest-multiplier
    active rows are GATHERED and the Schur system is 64x64: ~170x fewer
    factorization FLOPs and 5x less sequential triangular-solve depth.
    If more than 64 rows are truly active (degenerate), the dropped rows
    make the polished iterate violate its KKT system, its merit comes out
    higher, and the merit gate rejects it -- graceful, never wrong.
    """
    dtype = P_uu.dtype
    n = P_uu.shape[0]
    eye = jnp.eye(n, dtype=dtype)

    pen = jnp.where(m_pen, p_ss, 0.0)
    K = P_uu + (A.T * pen) @ A + reg * eye
    q_t = q_u + A.T @ jnp.where(m_pen, q_s - p_ss * b, 0.0)

    E = jnp.concatenate([G_u, A], axis=0)                  # [m_rows, n]
    e = jnp.concatenate([h1, b])
    act = jnp.concatenate([a1, m_eq])                      # bool [m_rows]
    m_rows = E.shape[0]
    # At a nondegenerate optimum at most n rows are active, so n + 4
    # selections suffice; capping lower would silently under-select and
    # degrade polish quality.  The merit gate still rejects any
    # degenerate over-truncation.
    k_sel = min(n + 4, m_rows)

    # Gather the active rows (highest multipliers first; inactive rows
    # that pad out the selection get va=0 and decouple as identity
    # rows).  The gather/scatter are expressed as one-hot matmuls
    # ([k_sel, m_rows] products, batched dense work under vmap) rather
    # than per-instance dynamic gathers.
    score = jnp.where(act, 1.0 + l_all, 0.0)
    _, idx = jax.lax.top_k(score, k_sel)
    sel = (idx[:, None] ==
           jnp.arange(m_rows)[None, :]).astype(dtype)      # [k_sel, m_rows]
    va = sel @ act.astype(dtype)                           # [k_sel]
    Eg = sel @ E                                           # [k_sel, n]
    eg = sel @ e

    LK = _factor(K)
    # One stacked multi-RHS solve instead of separate KiEg / Kiq
    # triangular solves: batched triangular solves cost by their
    # sequential depth more than by their FLOPs.
    KiEq = _solve(
        LK, jnp.concatenate([Eg.T, q_t[:, None]], axis=1))
    KiEg, Kiq = KiEq[:, :k_sel], KiEq[:, k_sel]
    Mg = (va[:, None] * (Eg @ KiEg) * va[None, :]
          + jnp.diag(1.0 - va)
          + reg * jnp.eye(k_sel, dtype=dtype))
    rhs = va * (-(Eg @ Kiq) - eg)
    LM = _factor(Mg)
    nug = va * _solve(LM, rhs)
    # u = -K^-1 (q_t + Eg' nu) = -(Kiq + KiEg nu): reuses the solved
    # blocks, no further triangular solve.
    u_p = -(Kiq + KiEg @ nug)

    # KKT iterative refinement on BOTH u and nu (f32 Cholesky + the reg
    # shift leave ~1e-5-relative residual in the first solve), against
    # the equality-constrained system
    #     K u + q_t + E_a' nu_a = 0,   E_a u = e_a.
    # The first pass takes a plain float32 residual; the second, in
    # compensated arithmetic (`dot2`, K applied term by term), brings u
    # to the float32 solution of the QP -- a plain residual stalls at
    # ~1e-4 in u, the size of the oracle bound.
    for accurate in (False, True):
        if accurate:
            y = dot2([A], [u_p], add=[-b])                 # A u - b
            z = jnp.where(m_pen, p_ss * y + q_s, 0.0)
            r1 = dot2([P_uu, A.T, Eg.T], [u_p, z, nug],
                      add=[q_u, reg * u_p])
            r2 = va * dot2([Eg], [u_p], add=[-eg])
        else:
            r1 = K @ u_p + q_t + Eg.T @ nug
            r2 = va * (Eg @ u_p - eg)
        t = _solve(LK, r1)
        dnu = va * _solve(LM, r2 - va * (Eg @ t))
        du = -(t + KiEg @ dnu)
        u_p = u_p + du
        nug = nug + dnu

    # Scatter the gathered multipliers back to full row indexing
    # (inactive rows carry nu = 0 by definition).
    return u_p, sel.T @ (nug * va)


def _solve_body(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, max_iters, tol, reg,
                polish=False, linsolve="chol", warm=None, box_theta=None):
    dtype = P_uu.dtype
    n = P_uu.shape[0]
    m1 = G_u.shape[0]
    m2 = A.shape[0]

    # Structure-exploiting G_u operators (see solve_mpc_qp docstring):
    # with the [I; -I; T; -T] box layout, matvec/rmatvec need one T
    # product instead of an m1 x n one, and the weighted Gram matrix is
    # a diagonal plus a T-sized product.
    if box_theta is not None:
        T = box_theta.astype(dtype)
        hp = T.shape[0]
        if m1 != 2 * n + 2 * hp:
            raise ValueError(
                f"box_theta layout expects m1 == 2n + 2hp rows "
                f"(got m1={m1}, n={n}, hp={hp})")

        def gu_mv(v):
            Tv = T @ v
            return jnp.concatenate([v, -v, Tv, -Tv])

        def gu_rmv(w):
            head = w[:n] - w[n:2 * n]
            return head + T.T @ (w[2 * n:2 * n + hp] - w[2 * n + hp:])

        def gu_quad(d):
            diag = d[:n] + d[n:2 * n]
            dT = d[2 * n:2 * n + hp] + d[2 * n + hp:]
            return jnp.diag(diag) + (T.T * dT) @ T
    else:
        def gu_mv(v):
            return G_u @ v

        def gu_rmv(w):
            return G_u.T @ w

        def gu_quad(d):
            return (G_u.T * d) @ G_u
    m_total = m1 + 2 * m2
    p_ss = jnp.broadcast_to(jnp.asarray(p_ss, dtype), (m2,))
    q_s = jnp.broadcast_to(jnp.asarray(q_s, dtype), (m2,))

    q_scale = jnp.maximum(jnp.maximum(jnp.max(jnp.abs(q_u)),
                                      jnp.max(jnp.abs(q_s))), 1.0)
    big = jnp.asarray(1e30, dtype)
    eye = jnp.eye(n, dtype=dtype)

    if warm is None:
        u = jnp.zeros((n,), dtype)
        s = jnp.zeros((m2,), dtype)
        w1 = jnp.maximum(h1, 1.0)
        w2 = jnp.maximum(b, 1.0)
        w3 = jnp.ones((m2,), dtype)
        l1 = jnp.clip(1.0 / w1, 1e-6, 1e6)
        l2 = jnp.clip(1.0 / w2, 1e-6, 1e6)
        l3 = jnp.clip(1.0 / w3, 1e-6, 1e6)
    else:
        # Warm start from a related solve's iterates: restore
        # interiority by flooring slacks/multipliers at 1e-2 (a large
        # floor keeps central-path mu moderate, which is what makes a
        # slightly-off seed converge instead of jamming on the
        # boundary).  Pure accelerator -- see solve_mpc_qp docstring.
        u0, s0, l10, l20, l30 = warm
        fl = jnp.asarray(1e-2, dtype)
        u = u0.astype(dtype)
        s = jnp.maximum(s0.astype(dtype), 0.0)
        w1 = jnp.maximum(h1 - gu_mv(u), fl)
        w2 = jnp.maximum(b - A @ u + s, fl)
        w3 = jnp.maximum(s, fl)
        l1 = jnp.clip(jnp.maximum(l10.astype(dtype), fl), 1e-6, 1e6)
        l2 = jnp.clip(jnp.maximum(l20.astype(dtype), fl), 1e-6, 1e6)
        l3 = jnp.clip(jnp.maximum(l30.astype(dtype), fl), 1e-6, 1e6)

    def merit_of(u, s, l1, l2, l3, w1, w2, w3):
        mu = (jnp.dot(l1, w1) + jnp.dot(l2, w2) + jnp.dot(l3, w3)) / m_total
        Au = A @ u
        viol_box = (jnp.max(jnp.maximum(gu_mv(u) - h1, 0.0))
                    if m1 > 0 else jnp.asarray(0.0, dtype))
        viol = jnp.maximum(
            viol_box,
            jnp.maximum(jnp.max(jnp.maximum(Au - s - b, 0.0)),
                        jnp.max(jnp.maximum(-s, 0.0))))
        rd_u = jnp.max(jnp.abs(P_uu @ u + q_u + gu_rmv(l1) + A.T @ l2))
        rd_s = jnp.max(jnp.abs(p_ss * s + q_s - l2 - l3))
        return (mu + viol + jnp.maximum(rd_u, rd_s)) / q_scale, mu

    def cond(state):
        return jnp.logical_not(state[-3]) & (state[-1] < max_iters)

    def body(state):
        u, s, w1, w2, w3, l1, l2, l3, best, done, stall, iters = state
        best_merit, bu, bs, bl, bw = best

        merit, mu = merit_of(u, s, l1, l2, l3, w1, w2, w3)
        better = merit < best_merit
        # Stagnation / breakdown detection: count iterations without a
        # material (0.5% relative) best-merit improvement; a non-finite
        # merit means the iterate broke down (tiny-mu float32 Cholesky),
        # in which case the tracked best iterate is the answer.
        improved = merit < best_merit * 0.995
        stall = jnp.where(improved, 0, stall + 1)
        broke = ~jnp.isfinite(merit)
        best_merit = jnp.where(better, merit, best_merit)
        bu = jnp.where(better, u, bu)
        bs = jnp.where(better, s, bs)
        bl = jax.tree_util.tree_map(
            lambda new, old: jnp.where(better, new, old), (l1, l2, l3), bl)
        bw = jax.tree_util.tree_map(
            lambda new, old: jnp.where(better, new, old), (w1, w2, w3), bw)

        r_du = P_uu @ u + q_u + gu_rmv(l1) + A.T @ l2
        r_ds = p_ss * s + q_s - l2 - l3
        r_p1 = gu_mv(u) + w1 - h1
        r_p2 = A @ u - s + w2 - b
        r_p3 = -s + w3

        d1 = jnp.clip(l1 / w1, 1e-10, 1e10)
        d2 = jnp.clip(l2 / w2, 1e-10, 1e10)
        d3 = jnp.clip(l3 / w3, 1e-10, 1e10)
        m_ss = p_ss + d2 + d3
        d2_eff = d2 - d2 * d2 / m_ss
        S = (P_uu + gu_quad(d1) + (A.T * d2_eff) @ A + reg * eye)
        Lchol = _factor(S)
        S_inv = _solve(Lchol, eye) if linsolve == "inv" else None

        def newton(rc1, rc2, rc3):
            t_s = (-r_ds + d2 * r_p2 - rc2 / w2 + d3 * r_p3 - rc3 / w3)
            rhs = (-r_du - gu_rmv(d1 * r_p1 - rc1 / w1)
                   - A.T @ (d2 * r_p2 - rc2 / w2)
                   + A.T @ (d2 * t_s / m_ss))
            du = (S_inv @ rhs if linsolve == "inv"
                  else _solve(Lchol, rhs))
            ds = (t_s + d2 * (A @ du)) / m_ss
            dl1 = d1 * (gu_mv(du) + r_p1) - rc1 / w1
            dl2 = d2 * (A @ du - ds + r_p2) - rc2 / w2
            dl3 = d3 * (-ds + r_p3) - rc3 / w3
            dw1 = -(rc1 + w1 * dl1) / l1
            dw2 = -(rc2 + w2 * dl2) / l2
            dw3 = -(rc3 + w3 * dl3) / l3
            return du, ds, dl1, dl2, dl3, dw1, dw2, dw3

        # Predictor.
        da = newton(l1 * w1, l2 * w2, l3 * w3)
        du_a, ds_a, dl1_a, dl2_a, dl3_a, dw1_a, dw2_a, dw3_a = da
        a_p = jnp.minimum(jnp.minimum(_pos_step(w1, dw1_a, 1.0),
                                      _pos_step(w2, dw2_a, 1.0)),
                          _pos_step(w3, dw3_a, 1.0))
        a_d = jnp.minimum(jnp.minimum(_pos_step(l1, dl1_a, 1.0),
                                      _pos_step(l2, dl2_a, 1.0)),
                          _pos_step(l3, dl3_a, 1.0))
        mu_aff = (jnp.dot(l1 + a_d * dl1_a, w1 + a_p * dw1_a)
                  + jnp.dot(l2 + a_d * dl2_a, w2 + a_p * dw2_a)
                  + jnp.dot(l3 + a_d * dl3_a, w3 + a_p * dw3_a)) / m_total
        sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3

        # Corrector.
        dc = newton(l1 * w1 + dl1_a * dw1_a - sigma * mu,
                    l2 * w2 + dl2_a * dw2_a - sigma * mu,
                    l3 * w3 + dl3_a * dw3_a - sigma * mu)
        du, ds, dl1, dl2, dl3, dw1, dw2, dw3 = dc
        a_p = jnp.minimum(jnp.minimum(_pos_step(w1, dw1, 0.99),
                                      _pos_step(w2, dw2, 0.99)),
                          _pos_step(w3, dw3, 0.99))
        a_d = jnp.minimum(jnp.minimum(_pos_step(l1, dl1, 0.99),
                                      _pos_step(l2, dl2, 0.99)),
                          _pos_step(l3, dl3, 0.99))

        conv = best_merit < tol
        done_n = done | conv | broke | (stall >= 10)
        keep = done_n
        u = jnp.where(keep, u, u + a_p * du)
        s = jnp.where(keep, s, s + a_p * ds)
        w1 = jnp.where(keep, w1, w1 + a_p * dw1)
        w2 = jnp.where(keep, w2, w2 + a_p * dw2)
        w3 = jnp.where(keep, w3, w3 + a_p * dw3)
        l1 = jnp.where(keep, l1, l1 + a_d * dl1)
        l2 = jnp.where(keep, l2, l2 + a_d * dl2)
        l3 = jnp.where(keep, l3, l3 + a_d * dl3)
        iters = jnp.where(done_n, iters, iters + 1)
        return (u, s, w1, w2, w3, l1, l2, l3,
                (best_merit, bu, bs, bl, bw), done_n, stall, iters)

    init = (u, s, w1, w2, w3, l1, l2, l3,
            (big, u, s, (l1, l2, l3), (w1, w2, w3)), jnp.asarray(False),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    # Every product in the solver runs at HIGHEST: a default-precision
    # float32 product may run in TF32 on the GPU.
    with jax.default_matmul_precision("highest"):
        out = jax.lax.while_loop(cond, body, init)
    u, s, w1, w2, w3, l1, l2, l3, best, done, stall, iters = out

    with jax.default_matmul_precision("highest"):
        merit, _ = merit_of(u, s, l1, l2, l3, w1, w2, w3)
    best_merit, bu, bs, bl, bw = best
    better = merit < best_merit
    best_merit = jnp.where(better, merit, best_merit)
    u = jnp.where(better, u, bu)
    s = jnp.where(better, s, bs)
    l1, l2, l3 = jax.tree_util.tree_map(
        lambda new, old: jnp.where(better, new, old), (l1, l2, l3), bl)
    w1, w2, w3 = jax.tree_util.tree_map(
        lambda new, old: jnp.where(better, new, old), (w1, w2, w3), bw)

    if polish:
        with jax.default_matmul_precision("highest"):
            pol = _polish(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, reg,
                          u, s, l1, l2, l3, w1, w2, w3)
            merit_p, _ = merit_of(*pol)
        use_p = jnp.isfinite(merit_p) & (merit_p < best_merit)
        u, s, l1, l2, l3, w1, w2, w3 = jax.tree_util.tree_map(
            lambda new, old: jnp.where(use_p, new, old),
            pol, (u, s, l1, l2, l3, w1, w2, w3))
        best_merit = jnp.where(use_p, merit_p, best_merit)

    with jax.default_matmul_precision("highest"):
        return _finalize(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, m_total,
                         m1, tol, dtype, u, s, l1, l2, l3, best_merit,
                         iters)


def _finalize(P_uu, q_u, G_u, h1, A, b, p_ss, q_s, m_total, m1, tol,
              dtype, u, s, l1, l2, l3, best_merit, iters):
    """Reported residuals/objective at HIGHEST precision (they are the
    caller-visible accuracy evidence)."""
    obj = (0.5 * u @ (P_uu @ u) + q_u @ u
           + 0.5 * jnp.dot(p_ss * s, s) + q_s @ s)
    # Complementarity gap from TRUE slacks (h - Gz), not the IPM's w
    # iterates: the polish forces w to `tiny` on active rows, which
    # would make a w-based gap synthetic rather than measured.
    s1_true = jnp.maximum(h1 - G_u @ u, 0.0)
    s2_true = jnp.maximum(b - A @ u + s, 0.0)
    s3_true = jnp.maximum(s, 0.0)
    gap = (jnp.dot(l1, s1_true) + jnp.dot(l2, s2_true)
           + jnp.dot(l3, s3_true)) / m_total
    viol_box = (jnp.max(jnp.maximum(G_u @ u - h1, 0.0))
                if m1 > 0 else jnp.asarray(0.0, dtype))
    viol = jnp.maximum(
        viol_box,
        jnp.maximum(jnp.max(jnp.maximum(A @ u - s - b, 0.0)),
                    jnp.max(jnp.maximum(-s, 0.0))))
    rd = jnp.maximum(
        jnp.max(jnp.abs(P_uu @ u + q_u + G_u.T @ l1 + A.T @ l2)),
        jnp.max(jnp.abs(p_ss * s + q_s - l2 - l3)))
    # Acceptance is 10x the iteration target (see module docstring) --
    # still far tighter than the reference's OSQP eps=1e-3 defaults.
    converged = best_merit < 10.0 * tol
    return MPCQPSolution(u, s, obj, gap, viol, rd, converged, iters,
                         best_merit, (l1, l2, l3))
