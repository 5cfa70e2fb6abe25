"""Safe-halfspace solvers under mean / CVaR / DR-CVaR risk metrics.

This module replaces the reference's per-instance CVXPY+ECOS convex
programs (reference core/risk_metrics.py:84-338 and the halfspace
factories core/halfspaces.py:66-194) with exact closed forms evaluated as
batched array reductions.

Derivation (why a closed form exists)
-------------------------------------
Let s_i = h . xi_i be the sampled obstacle positions projected on the
halfspace normal and r~ the combined-radius term.

* CVaR program (reference core/risk_metrics.py:199-211):
      min g  s.t.  eta_i >= -s_i - g + r~ - tau,  eta_i >= 0,
                   tau + 1/(alpha N) sum eta_i <= delta
  At the optimum eta_i = (-s_i - g + r~ - tau)_+, and minimizing over tau
  gives exactly the Rockafellar-Uryasev CVaR of the loss
  l_i = (-s_i + r~) - g.  CVaR is translation-equivariant in g, so
      g* = CVaR_alpha(-s) + r~ - delta.

* DR-CVaR program (reference core/risk_metrics.py:105-125): piecewise
  terms with a = b = [-1/alpha, 0], c = [1 - 1/alpha, 1] give
      eta_i = max( -(s_i + g - r~)/alpha + (1 - 1/alpha) tau,  tau ).
  Substituting w = tau/alpha, the inner minimum over tau of
  (1/N) sum eta_i equals alpha * CVaR_alpha((r~ - g - s)/alpha)
  = r~ - g + CVaR_alpha(-s).  The multiplier lambda appears only through
  lambda*epsilon <= ... with lambda >= 1/alpha (reference
  core/risk_metrics.py:110,124), so lambda* = 1/alpha and
      g* = CVaR_alpha(-s) + r~ - delta + epsilon/alpha.

  i.e. the Wasserstein-robust program is the CVaR program shifted by
  epsilon/alpha.  Both closed forms match ECOS to solver tolerance
  (verified in tests/test_halfspace_golden.py against an independent
  scipy.linprog oracle).

Offset conventions (replicated exactly, quirks included):
  * mean    : g~ = -(h . mu - r * ||h||)            (core/halfspaces.py:94)
  * cvar    : halfspace offset is g* itself          (core/halfspaces.py:131)
  * dr_cvar : halfspace offset is g* - r~            (core/risk_metrics.py:297)
  The reference's conservative failure default g = 100 (risk_metrics.py:177)
  is unreachable here: the closed form cannot fail.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.geometry import compute_separating_vector
from ..core.risk import cvar_rockafellar


def _project(samples, h):
    """s_i = h . xi_i at full f32 precision (a default-precision f32
    product may run in TF32 on the GPU; halfspace offsets need the exact
    projections)."""
    return jnp.einsum("...nd,...d->...n", samples, h,
                      precision=jax.lax.Precision.HIGHEST)


def _centered_diff(samples, ego_ref_pos):
    """mean(samples) - ego computed as mean(samples - ego).

    Numerically load-bearing: samples and ego are O(10) world positions
    while their difference near closest approach is O(1e-3).  Averaging
    FIRST leaves the subtraction's cancellation to amplify the f32
    representation error of the mean (~5e-7 absolute), which the
    normalization in `compute_separating_vector` blows up to ~1e-3 in h
    (measured accelerator-vs-CPU).  Subtracting first makes every summand
    O(sample spread), so rounding is ~1e-8 and the returned difference
    is accurate (and backend-stable) to ~1e-8 regardless of degeneracy.
    Returns (centered_samples [..., N, 2], diff [..., 2]).
    """
    centered = samples - ego_ref_pos[..., None, :]
    return centered, jnp.mean(centered, axis=-2)


def _normalize_diff(diff):
    """Unit vector from a (possibly tiny) difference, with the
    reference's [1, 0] degenerate fallback (core/geometry.py:35-53)."""
    norm = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    degen = norm < 1e-10
    fallback = jnp.zeros_like(diff).at[..., 0].set(1.0)
    return jnp.where(degen, fallback, diff / jnp.where(degen, 1.0, norm))


def _centered_cvar_neg_proj(centered, diff, h, ego_ref_pos, alpha):
    """CVaR_alpha(-h . xi) evaluated on doubly-centered projections.

    Identity (exact for any center c): CVaR(-h.xi) = CVaR(-h.(xi-c)) - h.c
    with c = ego + mean(xi - ego).  The centered projections are
    O(sample spread), so the order-statistic tail sums accumulate ~1e-8
    rounding instead of the ~2e-4 a naive f32 sum of O(10)-magnitude
    projections suffers (the round-2 on-chip g error).  The single f32
    rounding of the h.c correction (~5e-7) is the accuracy floor.
    """
    s_c = _project(centered - diff[..., None, :], h)
    center = ego_ref_pos + diff
    shift = jnp.sum(h * center, axis=-1)
    return cvar_rockafellar(-s_c, alpha) - shift


class Halfspace(NamedTuple):
    """Safe halfspace {y : h . y + g_tilde <= 0} (a pytree of arrays).

    Counterpart of the reference's SafeHalfspace object hierarchy
    (core/halfspaces.py:11-64); arbitrary leading batch axes.
    """

    h: jax.Array        # [..., 2] normal, ego -> obstacle
    g_tilde: jax.Array  # [...]    offset

    def is_point_safe(self, point):
        """h . p + g <= 0 (reference core/halfspaces.py:31-42)."""
        return jnp.sum(self.h * point, axis=-1) + self.g_tilde <= 0

    def distance_to_boundary(self, point):
        """Signed distance to the boundary (core/halfspaces.py:44-55)."""
        norm = jnp.linalg.norm(self.h, axis=-1)
        return (jnp.sum(self.h * point, axis=-1) + self.g_tilde) / norm

    def get_constraint_params(self):
        return self.h, self.g_tilde


def mean_halfspace(samples, robot_radius, obstacle_radius):
    """Analytic mean-risk halfspace (reference core/halfspaces.py:66-106).

    Note the reference quirk, replicated here: the separating vector is
    computed from the ORIGIN (not the ego position) toward the sample mean
    (core/halfspaces.py:88).

    samples: [..., N, 2] -> Halfspace with batch shape [...].
    """
    mean_pos = jnp.mean(samples, axis=-2)
    h = compute_separating_vector(jnp.zeros_like(mean_pos), mean_pos)
    r = robot_radius + obstacle_radius
    h_norm = jnp.linalg.norm(h, axis=-1)
    g_tilde = -(jnp.sum(h * mean_pos, axis=-1) - r * h_norm)
    return Halfspace(h, g_tilde)


def cvar_halfspace(samples, ego_ref_pos, alpha, delta,
                   robot_radius, obstacle_radius):
    """CVaR-risk halfspace, closed form.

    Equals the optimum of the reference's ECOS program
    (core/risk_metrics.py:179-265 via core/halfspaces.py:108-149).

    samples: [..., N, 2]; ego_ref_pos: [..., 2] (broadcastable).
    """
    ego = jnp.broadcast_to(ego_ref_pos,
                           samples.shape[:-2] + samples.shape[-1:])
    centered, diff = _centered_diff(samples, ego)
    h = _normalize_diff(diff)
    r_tilde = (robot_radius + obstacle_radius) * jnp.linalg.norm(h, axis=-1)
    cvar = _centered_cvar_neg_proj(centered, diff, h, ego, alpha)
    g_star = cvar + r_tilde - delta
    # Reference keeps g* as the halfspace offset for CVaR
    # (core/halfspaces.py:131: CVaRSafeHalfspace(h, g_value)).
    return Halfspace(h, g_star)


def dr_cvar_halfspace(samples, ego_ref_pos, alpha, delta, epsilon,
                      robot_radius, obstacle_radius):
    """DR-CVaR (Wasserstein-robust) halfspace, closed form.

    Equals the optimum of the reference's ECOS program
    (core/risk_metrics.py:84-177 via core/halfspaces.py:151-194):
    g* = CVaR_alpha(-s) + r~ - delta + epsilon/alpha, offset g* - r~.
    """
    ego = jnp.broadcast_to(ego_ref_pos,
                           samples.shape[:-2] + samples.shape[-1:])
    centered, diff = _centered_diff(samples, ego)
    h = _normalize_diff(diff)
    r_tilde = (robot_radius + obstacle_radius) * jnp.linalg.norm(h, axis=-1)
    cvar = _centered_cvar_neg_proj(centered, diff, h, ego, alpha)
    g_star = cvar + r_tilde - delta + epsilon / alpha
    return Halfspace(h, g_star - r_tilde)


def _cvar_neg_proj_meancentered(samples, h, alpha):
    """CVaR_alpha(-h . xi) centered on the sample mean (exact shift
    identity; see _centered_cvar_neg_proj for why centering matters)."""
    c = jnp.mean(samples, axis=-2)
    s_c = _project(samples - c[..., None, :], h)
    shift = jnp.sum(h * c, axis=-1)
    return cvar_rockafellar(-s_c, alpha) - shift


def dr_cvar_g_star(samples, h, alpha, delta, epsilon,
                   robot_radius, obstacle_radius):
    """Raw (g*, g_tilde) pair for a given normal h, matching the signature
    contract of reference core/risk_metrics.py:268-303."""
    r_tilde = (robot_radius + obstacle_radius) * jnp.linalg.norm(h, axis=-1)
    g_star = (_cvar_neg_proj_meancentered(samples, h, alpha)
              + r_tilde - delta + epsilon / alpha)
    return g_star, g_star - r_tilde


def cvar_g_star(samples, h, alpha, delta, robot_radius, obstacle_radius):
    """Raw g* for a given normal h (reference core/risk_metrics.py:306-338)."""
    r_tilde = (robot_radius + obstacle_radius) * jnp.linalg.norm(h, axis=-1)
    return _cvar_neg_proj_meancentered(samples, h, alpha) + r_tilde - delta


def kth_largest_radix_select(x, k: int, n_iters: int | None = None):
    """Exact k-th largest element along the last axis without sorting.

    Bisects on the IEEE-754 bit pattern (monotone for floats after sign
    fold), using only masked counts per step -- every step is a pure
    elementwise compare + reduction, so (a) under a sharded sample axis
    each count becomes a `psum` and the selection runs sample-parallel
    across chips (parallel/sample_parallel.py), and (b) under a sharded
    BATCH axis XLA partitions it with zero collectives, unlike
    `lax.top_k` whose TopK custom call gets all-gathered by the SPMD
    partitioner (parallel/scaling.py census).

    Supports float32 (32-bit keys) and float64 (64-bit keys; the f64
    path exists for the CPU oracle-parity suite -- the GPU runs f32).
    """
    if x.dtype == jnp.float64:
        ui, nbits = jnp.uint64, 64
        sign_mask = jnp.uint64(0x8000000000000000)
        ones = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    else:
        if x.dtype != jnp.float32:
            x = x.astype(jnp.float32)
        ui, nbits = jnp.uint32, 32
        sign_mask = jnp.uint32(0x80000000)
        ones = jnp.uint32(0xFFFFFFFF)
    if n_iters is None:
        n_iters = nbits

    # Monotone map float -> unsigned total order: flip the sign bit for
    # non-negatives, flip all bits for negatives.
    u = jax.lax.bitcast_convert_type(x, ui)
    sign = u >> (nbits - 1)
    keys = jnp.where(sign == 1, ~u, u ^ sign_mask)

    def body(_, bounds):
        # Invariant: count(keys >= lo) >= k; search the largest such lo.
        lo, hi = bounds
        mid = lo + (hi - lo) // 2 + (hi - lo) % 2  # round up
        count = jnp.sum(keys >= mid[..., None], axis=-1)
        ok = count >= k
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid - ui(1))

    batch_shape = x.shape[:-1]
    lo0 = jnp.zeros(batch_shape, ui)
    hi0 = jnp.full(batch_shape, ones, ui)
    lo, _ = jax.lax.fori_loop(0, n_iters, body, (lo0, hi0))

    kth_u = jnp.where(lo >> (nbits - 1) == 1, lo ^ sign_mask, ~lo)
    return jax.lax.bitcast_convert_type(kth_u, x.dtype)
