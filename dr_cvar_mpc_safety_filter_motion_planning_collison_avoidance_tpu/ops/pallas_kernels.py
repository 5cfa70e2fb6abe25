"""Fused halfspace kernel for the GPU (Pallas, Triton route).

`fused_metric_halfspaces` computes, from ONE read of each instance's
samples, everything the three closed forms of ops/halfspace.py compute
(reference core/halfspaces.py:66-194 + core/risk_metrics.py:84-338):

  mean -> separating vector h -> projections s = h.xi ->
  exact k-th largest of (-s) by an order-statistic select ->
  tail-mean CVaR -> mean / CVaR / DR-CVaR offsets

Why a kernel: the XLA closed form materialises a [B, N] uint32 key
array and makes 32 fixed bisection passes over it
(ops/halfspace.kth_largest_radix_select).  At N=1000, B=32768 that
array is 131 MB, larger than the H100's 50 MB L2, so every pass streams
it from device memory again.  Here a program holds its rows in
registers, reads each sample once, and runs the select on chip.

Design for the Triton route:
  * a program owns `rows` whole sample rows, padded to a power of two
    `n_pad` columns; out-of-range rows and columns are masked loads, so
    the wrapper neither pads nor de-interleaves the [B, N, 2] input;
  * the select is moment-seeded 4-ary (N < 1024) or 3-ary packed-count
    bisection on the monotone IEEE-754 key order (`_select_lo`): one
    block reduction per round, early exit per program;
  * rows wider than `KERNEL_MAX_N` take the XLA closed form
    (simulation/environment.py chooses by N).
"""

from __future__ import annotations

import functools
import math
from statistics import NormalDist

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_EPS = 1e-10

# The packed count passes carry two count fields per int32 (or three
# 10-bit fields when n < 1024); the dual fields widen with n up to 15
# bits each, so n <= 32767.  A count above the field limit would bleed
# into the neighbouring field and SILENTLY corrupt the bisection, hence
# the hard guard.
MAX_N_SAMPLES = 32767

# Widest sample row the production path hands to the kernel.  A program
# keeps its rows in registers; beyond this width the environment takes
# the XLA closed form.  4096 is the widest shape measured on the card
# (PERF.md, "Kernel decisions on the H100").
KERNEL_MAX_N = 4096

# Key of -float32_max: the smallest key any FINITE float can have.
# Clamping pivots here keeps float-space compares exact: a pivot below
# it would decode to a negative NaN whose compares all come out false
# (wrong count); at or above it, x >= decode(m) <=> key(x) >= m.
_KEY_FIN_MIN = 0x00800000


def _row_key(v):
    """Monotone IEEE-754 float32 -> uint32 key map."""
    u = jax.lax.bitcast_convert_type(v, jnp.uint32)
    return jnp.where(u >> 31 == 1, ~u, u ^ jnp.uint32(0x80000000))


def _row_float(m):
    """Inverse of `_row_key` (exact bijection on non-NaN patterns)."""
    u = jnp.where(m >> 31 == 1, m ^ jnp.uint32(0x80000000), ~m)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def _select_lo(x, sigma, k: int, n_samples: int):
    """Order-statistic select: the uint32 key `lo` per row whose decoded
    float thresholds the exact top-k of that row of `x` [rows, n_pad].

      * every COUNT compares the f32 data directly against the decoded
        pivot (`_row_float`); bookkeeping runs in key space on [rows]
        vectors -- the monotone key map makes the two equivalent;
      * Chebyshev bracket: |x| <= sigma*sqrt(n) for every finite x
        (from sum x^2 = n sigma^2), so no min/max pass is needed;
      * moment-seeded round 1: pivots at (z -+ margin) * sigma with
        z = Phi^-1(1 - k/n) trap near-Gaussian rows in about one octave;
      * then uniform span/4 (n < 1024) or span/3 pivots, all counts of a
        round packed into ONE int32 block reduction, until every row has
        count(>= lo) == k or a collapsed interval.  In BOTH exit states
        the exact k-th largest is v = min{x : key(x) >= lo}.

    Padding columns must hold -inf: they fail every compare against the
    decoded pivots, so they never enter a count.
    """
    rows = x.shape[0]
    # The margin covers the f32 rounding of the sum of squares behind
    # sigma (a worst-order n-term f32 sum carries ~n*2^-24 relative
    # error); an over-wide bracket costs next to nothing.
    rad = sigma * jnp.float32(math.sqrt(n_samples)
                              * (1.0 + 32.0 * n_samples * 2.0 ** -24))
    lo0 = jnp.maximum(_row_key(-rad), jnp.uint32(_KEY_FIN_MIN))
    hi0 = _row_key(rad)
    # Invariants: count(>= lo) >= k with c_lo its count; count(> hi) < k.
    c0 = jnp.full((rows,), n_samples, jnp.int32)

    def row_done(lo, hi, c_lo):
        return (c_lo == k) | (lo >= hi)

    # Dual-packed field width: counts reach n_samples, so fields carry
    # ceil(log2(n+1)) bits (>= 11).  Two fields fit an int32 without
    # the top field reaching the sign bit: fb <= 15 <=> n <= 32767.
    fb = max(11, int(n_samples).bit_length())
    fmask = (1 << fb) - 1

    def count2(f1, f2):
        d = ((x >= f1[:, None]).astype(jnp.int32)
             + (x >= f2[:, None]).astype(jnp.int32) * (1 << fb))
        # dtype pinned: under jax_enable_x64 an int32 sum would promote.
        w = jnp.sum(d, axis=1, dtype=jnp.int32)
        return w & fmask, w >> fb

    def count3(f1, f2, f3):
        """Three counts in 10-bit fields: valid only for n < 1024."""
        d = ((x >= f1[:, None]).astype(jnp.int32)
             + (x >= f2[:, None]).astype(jnp.int32) * 1024
             + (x >= f3[:, None]).astype(jnp.int32) * 1048576)
        w = jnp.sum(d, axis=1, dtype=jnp.int32)
        return w & 1023, (w >> 10) & 1023, w >> 20

    one = jnp.uint32(1)

    def update(lo, hi, c_lo, pivots, counts):
        """Move `lo` to the highest pivot whose count still reaches k and
        `hi` just below the next one; frozen rows keep their state."""
        frozen = row_done(lo, hi, c_lo)
        lo_n, c_n, hi_n = lo, c_lo, pivots[0] - one
        for j, (m, c) in enumerate(zip(pivots, counts)):
            ok = c >= k
            nxt = pivots[j + 1] - one if j + 1 < len(pivots) else hi
            lo_n = jnp.where(ok, m, lo_n)
            c_n = jnp.where(ok, c, c_n)
            hi_n = jnp.where(ok, nxt, hi_n)
        return (jnp.where(frozen, lo, lo_n),
                jnp.where(frozen, hi, hi_n),
                jnp.where(frozen, c_lo, c_n))

    # Round 1 (unrolled): moment-seeded pivots around the Gaussian
    # k/n-quantile.  Any data stays CORRECT (the update keeps its
    # invariants for arbitrary in-range pivots); a missed guess only
    # costs extra rounds.
    q = min(max(1.0 - k / n_samples, 1e-7), 1.0 - 1e-7)
    z = NormalDist().inv_cdf(q)
    m1 = jnp.minimum(jnp.maximum(_row_key(jnp.float32(z - 0.55) * sigma),
                                 lo0 + one), hi0)
    m2 = jnp.minimum(jnp.maximum(_row_key(jnp.float32(z + 0.65) * sigma),
                                 m1), hi0)
    c1, c2 = count2(_row_float(m1), _row_float(m2))
    lo1, hi1, cc1 = update(lo0, hi0, c0, (m1, m2), (c1, c2))

    def cond(state):
        t, lo, hi, c_lo = state
        # 3^22 > 2^32: 22 rounds always collapse the interval.
        pending = jnp.sum((~row_done(lo, hi, c_lo)).astype(jnp.int32))
        return (t < 22) & (pending > 0)

    def body(state):
        t, lo, hi, c_lo = state
        span = hi - lo
        if n_samples < 1024:
            q4 = span // 4
            # q4*j, not (span*j)//4: span can exceed 2^31 (keys of
            # mixed-sign data straddle 0x80000000) and would wrap.
            ms = (lo + q4 + one, lo + q4 * 2 + one, lo + q4 * 3 + one)
            cs = count3(*(_row_float(m) for m in ms))
        else:
            third = span // 3
            ms = (lo + third + one, lo + third * 2 + one)
            cs = count2(*(_row_float(m) for m in ms))
        return (t + 1,) + update(lo, hi, c_lo, ms, cs)

    _, lo, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), lo1, hi1, cc1))
    return lo


def _block_cvar(x, sigma, k: int, alpha: float, n_samples: int):
    """Exact CVaR_alpha along axis 1 of x [rows, n_pad].

    With G = {x : x >= f_lo} (exactly the >=-k-th elements in both exit
    states of `_select_lo`), v = min G is the exact k-th largest, and
    the tie-safe tail mean (sum_{x>v} x + (an - #{x>v}) v)/an rewrites
    in G-quantities only -- the tie count cancels:
      CVaR = (sum_G + (an - |G|) v)/an.
    """
    f_lo = _row_float(_select_lo(x, sigma, k, n_samples))
    ge = x >= f_lo[:, None]
    v = jnp.min(jnp.where(ge, x, jnp.float32(jnp.inf)), axis=1)
    c = jnp.sum(ge.astype(jnp.float32), axis=1)
    s = jnp.sum(jnp.where(ge, x, jnp.float32(0.0)), axis=1)
    an = alpha * n_samples
    return (s + (an - c) * v) / an


def _unit(dx, dy):
    """Unit vector with the reference's [1, 0] degenerate fallback
    (reference core/geometry.py:35-53)."""
    norm = jnp.sqrt(dx * dx + dy * dy)
    degen = norm < _EPS
    safe = jnp.where(degen, 1.0, norm)
    return jnp.where(degen, 1.0, dx / safe), jnp.where(degen, 0.0, dy / safe)


def _metrics_kernel(s_ref, e_ref, hm_ref, gm_ref, h_ref, gc_ref, gd_ref,
                    *, n_batch: int, n_samples: int, n_pad: int, rows: int,
                    k: int, alpha: float, delta: float, epsilon: float,
                    r_combined: float):
    """`rows` instances: samples [rows, n_pad] x 2 -> all three metrics.

    Emits (reference offset conventions, see ops/halfspace.py):
      * mean    : h_mean = mean/|mean| from the ORIGIN (quirk of
                  reference core/halfspaces.py:88), g = r~ - h_mean.mean
      * cvar    : h from ego, offset g* = CVaR(-s) + r~ - delta
      * dr_cvar : same h, offset g* - r~ = CVaR(-s) - delta + eps/alpha
    cvar and dr_cvar differ by a constant, so one select serves both.
    """
    r0 = pl.program_id(0) * rows
    row_ok = r0 + jnp.arange(rows, dtype=jnp.int32) < n_batch
    col_ok = jnp.arange(n_pad, dtype=jnp.int32) < n_samples
    mask = row_ok[:, None] & col_ok[None, :]
    # int32 indices throughout: under jax_enable_x64 a Python int would
    # become int64 and mix index types.
    i0, i1 = jnp.int32(0), jnp.int32(1)
    rs, cs = pl.ds(r0, rows), pl.ds(i0, n_pad)
    sx = plgpu.load(s_ref.at[rs, cs, i0], mask=mask, other=0.0)
    sy = plgpu.load(s_ref.at[rs, cs, i1], mask=mask, other=0.0)
    ex = plgpu.load(e_ref.at[rs, i0], mask=row_ok, other=0.0)
    ey = plgpu.load(e_ref.at[rs, i1], mask=row_ok, other=0.0)

    # Means taken as mean(xi - ego): every summand is O(sample spread),
    # so the f32 rounding of the mean stays ~1e-8 -- below what the
    # h-normalisation at closest approach can amplify into the controls.
    inv_n = jnp.float32(1.0 / n_samples)
    dx = jnp.sum(jnp.where(mask, sx - ex[:, None], 0.0), axis=1) * inv_n
    dy = jnp.sum(jnp.where(mask, sy - ey[:, None], 0.0), axis=1) * inv_n
    hx, hy = _unit(dx, dy)

    # Doubly-centred projections x = -(h . (xi - mean)) (exact shift
    # identity, see ops/halfspace._centered_cvar_neg_proj) and their
    # second moment for the select's bracket.
    mx = ex + dx
    my = ey + dy
    xv = (mx[:, None] - sx) * hx[:, None] + (my[:, None] - sy) * hy[:, None]
    s2 = jnp.sum(jnp.where(mask, xv * xv, 0.0), axis=1)
    sigma = jnp.sqrt(s2 * inv_n)
    x = jnp.where(mask, xv, jnp.float32(-jnp.inf))
    cvar = (_block_cvar(x, sigma, k, alpha, n_samples)
            - (hx * mx + hy * my))

    hmx, hmy = _unit(mx, my)
    g_mean = -(hmx * mx + hmy * my - r_combined)

    # h is unit (or the unit fallback), so r~ = r_combined.
    plgpu.store(hm_ref.at[rs, i0], hmx, mask=row_ok)
    plgpu.store(hm_ref.at[rs, i1], hmy, mask=row_ok)
    plgpu.store(gm_ref.at[rs], g_mean, mask=row_ok)
    plgpu.store(h_ref.at[rs, i0], hx, mask=row_ok)
    plgpu.store(h_ref.at[rs, i1], hy, mask=row_ok)
    plgpu.store(gc_ref.at[rs], cvar + r_combined - delta, mask=row_ok)
    plgpu.store(gd_ref.at[rs], cvar - delta + epsilon / alpha, mask=row_ok)


def launch_config(n_samples: int) -> tuple[int, int]:
    """(rows per program, num_warps) for a sample width.

    One row of at least 1024 padded columns per 4-warp program: on the
    H100 that beat 2, 4 and 8 rows and 8 or 16 warps at N=1000 and
    N=4096 (PERF.md, "Kernel decisions on the H100").  Narrower rows
    share a program up to ~1024 elements."""
    return max(1, 1024 // pl.next_power_of_2(n_samples)), 4


@functools.partial(jax.jit,
                   static_argnames=("alpha", "delta", "epsilon",
                                    "robot_radius", "obstacle_radius",
                                    "rows", "num_warps", "interpret"))
def fused_metric_halfspaces(samples, ego_ref_pos, alpha: float,
                            delta: float, epsilon: float,
                            robot_radius: float, obstacle_radius: float,
                            rows: int | None = None,
                            num_warps: int | None = None,
                            interpret: bool = False):
    """All three risk metrics' halfspaces from one read of the samples.

    The GPU path of
    simulation/environment.compute_safe_halfspaces_for_trajectory
    (the reference computes them as three separate CVXPY programs,
    core/halfspaces.py:196-248).

    Args:
      samples: [B, N, 2] float32; ego_ref_pos: [B, 2].
      rows, num_warps: launch shape; `launch_config(N)` when None.
      interpret: run the kernel body on the CPU (tests only).
    Returns:
      (h_mean [B,2], g_mean [B], h_ego [B,2], g_cvar [B], g_drcvar [B])
      matching ops/halfspace.{mean,cvar,dr_cvar}_halfspace.
    """
    B, N, _ = samples.shape
    if N > MAX_N_SAMPLES:
        raise ValueError(
            f"fused halfspace kernel supports n_samples <= {MAX_N_SAMPLES} "
            f"(packed bit-field counts), got {N}; use ops/halfspace's XLA "
            "closed form or the sample-sharded path "
            "(parallel/sample_parallel.py) for larger N")
    auto_rows, auto_warps = launch_config(N)
    rows = auto_rows if rows is None else rows
    num_warps = auto_warps if num_warps is None else num_warps
    if rows & (rows - 1):
        raise ValueError(f"rows per program must be a power of two, "
                         f"got {rows}")
    k = max(min(int(math.ceil(alpha * N - 1e-12)), N), 1)
    kernel = functools.partial(
        _metrics_kernel, n_batch=B, n_samples=N,
        n_pad=pl.next_power_of_2(N), rows=rows, k=k, alpha=alpha,
        delta=delta, epsilon=epsilon,
        r_combined=float(robot_radius + obstacle_radius))
    vec = jax.ShapeDtypeStruct((B, 2), jnp.float32)
    scl = jax.ShapeDtypeStruct((B,), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=(vec, scl, vec, scl, scl),
        grid=(pl.cdiv(B, rows),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="fused_metric_halfspaces",
    )(samples.astype(jnp.float32), ego_ref_pos.astype(jnp.float32))
