"""Empirical risk metrics: mean, VaR, CVaR.

Counterpart of reference core/risk_metrics.py:35-82 plus the
exact Rockafellar-Uryasev empirical CVaR used by the halfspace solvers.

Two CVaR conventions live here on purpose:

  * `var_metric` / `cvar_metric` replicate the reference's standalone
    empirical estimators *exactly*, including their index convention
    (sort ascending, take element ceil(N*(1-alpha)) - 1, reference
    core/risk_metrics.py:58-60) and the tail-mean-over->=VaR definition
    (core/risk_metrics.py:74-82).

  * `cvar_rockafellar` is the exact optimal value of
        min_tau  tau + 1/(alpha*N) * sum_i (x_i - tau)_+
    which is the quantity the reference's CVaR/DR-CVaR convex programs
    (core/risk_metrics.py:110-122, 199-211) optimize over.  This is the
    one the halfspace solvers use; it matches ECOS solutions to
    solver tolerance.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def expected_value(samples, axis=0):
    """Sample mean (reference core/risk_metrics.py:35-45)."""
    return jnp.mean(samples, axis=axis)


def var_metric(samples, alpha: float):
    """Empirical VaR with the reference's convention.

    sorted ascending; index = ceil(N * (1 - alpha)); return sorted[index-1]
    (reference core/risk_metrics.py:47-60).  `samples` is 1-D.
    """
    n = samples.shape[-1]
    index = int(math.ceil(n * (1.0 - alpha)))
    sorted_samples = jnp.sort(samples, axis=-1)
    return sorted_samples[..., index - 1]


def cvar_metric(samples, alpha: float):
    """Empirical CVaR as mean of samples >= VaR (falls back to VaR when the
    tail is empty), replicating reference core/risk_metrics.py:62-82."""
    var = var_metric(samples, alpha)
    mask = samples >= var[..., None]
    count = jnp.sum(mask, axis=-1)
    tail_mean = jnp.sum(jnp.where(mask, samples, 0.0), axis=-1) / jnp.maximum(count, 1)
    return jnp.where(count == 0, var, tail_mean)


def cvar_rockafellar(x, alpha: float):
    """Exact empirical CVaR_alpha along the last axis.

    CVaR_alpha(x) = min_tau tau + 1/(alpha*N) sum_i (x_i - tau)_+
                  = (sum_{x_i > v} x_i + (alpha*N - #{x_i > v}) * v) / (alpha*N)

    with v = x_[k] the k-th largest sample, k = ceil(alpha * N).  For
    integer alpha*N this is the mean of the k largest samples.  Exact
    (not iterative in value -- the order statistic is found by exact
    bit-pattern bisection), so it reproduces the optimal value of the
    reference's ECOS-solved programs to float precision.

    Implementation note: v comes from `kth_largest_radix_select`, NOT
    `jax.lax.top_k` -- under a sharded batch axis XLA's SPMD partitioner
    all-gathers TopK custom calls (replicating the whole batch on every
    device, measured in parallel/scaling.py), while the radix select is
    pure elementwise ops + reductions and partitions cleanly.
    """
    from ..ops.halfspace import kth_largest_radix_select

    n = x.shape[-1]
    k = int(math.ceil(alpha * n - 1e-12))
    k = max(min(k, n), 1)
    v = kth_largest_radix_select(x, k)
    return cvar_from_kth(x, v, alpha)


def cvar_from_kth(x, kth_value, alpha: float):
    """CVaR from a known k-th largest value (tie-safe masked form).

    With v = x_[k] (k = ceil(alpha*N)) and c = #{x_i > v}:
        CVaR = (sum_{x_i > v} x_i + (alpha*N - c) * v) / (alpha*N)
    Used by the radix-select / sample-parallel paths where the order
    statistic is found by bisection and only masked sums are available
    (each is a `psum` when the sample axis is sharded).
    """
    n = x.shape[-1]
    an = alpha * n
    gt = x > kth_value[..., None]
    c = jnp.sum(gt, axis=-1).astype(x.dtype)
    tail_sum = jnp.sum(jnp.where(gt, x, 0.0), axis=-1)
    return (tail_sum + (an - c) * kth_value) / an
