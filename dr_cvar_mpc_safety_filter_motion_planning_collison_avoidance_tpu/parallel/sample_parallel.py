"""Sample-parallel DR-CVaR: shard the N-sample axis over chips.

For very large N (e.g. the 1500-sample end of the timing sweep, or
N >> 1e5 research settings) the Monte-Carlo sample axis itself can be
sharded.  The CVaR tail reduction needs the k-th largest projection --
an order statistic, computed by moment-seeded 3-ary early-exit
bisection in which every round needs only COUNTS of samples above two
pivots, and counts are `psum`s (one packed psum per round).  The whole
solver thus runs sample-parallel with ~11 collective rounds per
halfspace batch (one packed-extremes pmax, one moments psum, ~7
measured bisection rounds incl. the seeded first, packed count/sum
psum, final pmin -- SCALING.json `rounds_per_solve`), all over the
device interconnect (NVLink between the cards of one host).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

def _distributed_kth_largest(x_local, k: int, n_global: int,
                             axis_name: str, max_rounds: int = 22,
                             return_rounds: bool = False):
    """EXACT k-th largest over the GLOBAL (sharded) last axis.

    The same moment-seeded 3-ary early-exit bisection as the in-kernel
    select (ops/pallas_kernels._select_lo), in collective form.
    Collective cost per solve batch:

      * ONE pmax: both global key-span extremes ride one collective
        (the complement trick packs the global min as
        0xFFFFFFFF - min) -- bounds are EXACT, so correctness never
        rests on the seeding;
      * ONE psum: sum + sum-of-squares for the seeding moments; the
        seeded first round's pivots at mu + (z -+ margin)*sigma trap
        near-Gaussian rows in ~1 octave, replacing ~4-5 uniform
        rounds;
      * per round, ONE psum carrying BOTH pivot counts (stacked on a
        trailing axis -- one latency-bound collective, two payload
        ints), cutting the interval 3x;
      * early exit the moment every batch row has count(keys >= lo)
        == k or a collapsed interval; counts are psum-synchronized, so
        all devices exit on the same round with no extra collective.

    Typical Gaussian data resolves in ~7 total bisection rounds (seeded
    first round included; measured in SCALING.json
    rounds-per-solve annotation).  x_local: [..., N_local].
    """
    from statistics import NormalDist

    xf = x_local.astype(jnp.float32)
    u = jax.lax.bitcast_convert_type(xf, jnp.uint32)
    keys = jnp.where(u >> 31 == 1, ~u, u ^ jnp.uint32(0x80000000))

    def fkey(v):
        """float32 -> monotone uint32 key (same map as `keys`)."""
        uu = jax.lax.bitcast_convert_type(v, jnp.uint32)
        return jnp.where(uu >> 31 == 1, ~uu, uu ^ jnp.uint32(0x80000000))

    # ONE pmax carries BOTH global extremes: the complement trick turns
    # the global min into a max (0xFFFFFFFF - min), replacing the
    # round-4 pmin+pmax pair with a single collective.  Bounds stay
    # EXACT (no moment-margin proof obligation: correctness never
    # depends on the seeding below).
    full = jnp.uint32(0xFFFFFFFF)
    ext_local = jnp.stack([jnp.max(keys, axis=-1),
                           full - jnp.min(keys, axis=-1)], axis=-1)
    ext = jax.lax.pmax(ext_local, axis_name)
    hi0 = ext[..., 0]
    lo0 = full - ext[..., 1]
    # Invariants: count(>= lo0) == n_global >= k; count(>= hi0+1) == 0.
    c0 = jnp.full(x_local.shape[:-1], n_global, jnp.int32)
    # lo0/hi0 come out of the collective already varying over the other
    # manual axes but invariant over `axis_name`; the constant c0 must
    # declare the same varying set or the while_loop rejects the carry
    # (vma mismatch under shard_map).
    batch_vma = tuple(a for a in getattr(jax.typeof(lo0), "vma", ()))
    if batch_vma:
        c0 = jax.lax.pcast(c0, batch_vma, to="varying")

    def row_done(lo, hi, c_lo):
        return (c_lo == k) | (lo >= hi)

    # Moment-seeded ROUND 1 (the kernel's round-1 trick in collective
    # form, round 5): ONE psum carries sum and sum-of-squares; the
    # first pivots sit at mu + (z -+ margin) * sigma with
    # z = Phi^-1(1 - k/n), trapping near-Gaussian rows in a ~1-octave
    # interval in one round and replacing ~4-5 uniform 3-ary rounds.
    # Seeding is correctness-free: pivots are clamped into (lo0, hi0]
    # and the count-based interval invariants hold for ANY in-range
    # pivot placement; a missed guess only costs rounds.
    mom_local = jnp.stack([jnp.sum(xf, axis=-1),
                           jnp.sum(xf * xf, axis=-1)], axis=-1)
    mom = jax.lax.psum(mom_local, axis_name)
    mu = mom[..., 0] / n_global
    sigp = jnp.sqrt(jnp.maximum(mom[..., 1] / n_global - mu * mu, 0.0))
    qz = min(max(1.0 - k / n_global, 1e-7), 1.0 - 1e-7)
    z = NormalDist().inv_cdf(qz)
    one = jnp.uint32(1)
    s1 = jnp.minimum(jnp.maximum(fkey(mu + jnp.float32(z - 0.55) * sigp),
                                 lo0 + one), hi0)
    s2 = jnp.minimum(jnp.maximum(fkey(mu + jnp.float32(z + 0.65) * sigp),
                                 s1), hi0)
    l1s = jnp.sum(keys >= s1[..., None], axis=-1).astype(jnp.int32)
    l2s = jnp.sum(keys >= s2[..., None], axis=-1).astype(jnp.int32)
    cs = jax.lax.psum(jnp.stack([l1s, l2s], axis=-1), axis_name)
    c1s, c2s = cs[..., 0], cs[..., 1]
    ok2s = c2s >= k
    ok1s = c1s >= k
    frozen0 = row_done(lo0, hi0, c0)
    lo1 = jnp.where(frozen0, lo0,
                    jnp.where(ok2s, s2, jnp.where(ok1s, s1, lo0)))
    cc1 = jnp.where(frozen0, c0,
                    jnp.where(ok2s, c2s, jnp.where(ok1s, c1s, c0)))
    hi1 = jnp.where(frozen0, hi0,
                    jnp.where(ok2s, hi0,
                              jnp.where(ok1s, s2 - one, s1 - one)))

    def cond(state):
        t, lo, hi, c_lo = state
        return jnp.logical_and(t < max_rounds,
                               ~jnp.all(row_done(lo, hi, c_lo)))

    def body(state):
        t, lo, hi, c_lo = state
        span = hi - lo
        third = span // 3
        m1 = lo + third + jnp.uint32(1)            # lo < m1 <= m2 <= hi
        # third*2, not (span*2)//3: span can exceed 2^31 and wrap.
        m2 = lo + third * 2 + jnp.uint32(1)
        l1 = jnp.sum(keys >= m1[..., None], axis=-1).astype(jnp.int32)
        l2 = jnp.sum(keys >= m2[..., None], axis=-1).astype(jnp.int32)
        counts = jax.lax.psum(jnp.stack([l1, l2], axis=-1), axis_name)
        c1, c2 = counts[..., 0], counts[..., 1]
        ok2 = c2 >= k
        ok1 = c1 >= k
        frozen = row_done(lo, hi, c_lo)
        lo_n = jnp.where(ok2, m2, jnp.where(ok1, m1, lo))
        c_n = jnp.where(ok2, c2, jnp.where(ok1, c1, c_lo))
        hi_n = jnp.where(ok2, hi,
                         jnp.where(ok1, m2 - jnp.uint32(1),
                                   m1 - jnp.uint32(1)))
        return (t + 1,
                jnp.where(frozen, lo, lo_n),
                jnp.where(frozen, hi, hi_n),
                jnp.where(frozen, c_lo, c_n))

    t, lo, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(1), lo1, hi1, cc1))

    # Exact k-th largest (both exit states, same argument as
    # _block_cvar): global min over elements whose key is >= lo.
    v_local = jnp.min(
        jnp.where(keys >= lo[..., None], x_local.astype(jnp.float32),
                  jnp.float32(jnp.inf)), axis=-1)
    v = jax.lax.pmin(v_local, axis_name)
    # `t` = bisection rounds taken (1 psum each, seeded round incl.);
    # total collective rounds per solve = t + 3 (extremes pmax,
    # moments psum, final pmin).
    return (v, lo, t) if return_rounds else (v, lo)


def _distributed_cvar(x_local, alpha: float, n_global: int, axis_name: str):
    """Exact global CVaR_alpha along a sharded last axis (psum form of
    core/risk.cvar_from_kth)."""
    an = alpha * n_global
    k = max(min(int(math.ceil(an - 1e-12)), n_global), 1)
    v, lo = _distributed_kth_largest(x_local, k, n_global, axis_name)
    # Tie-safe tail mean from the >=-set G = {x : key(x) >= lo} only
    # (the tie count cancels algebraically -- see
    # ops/pallas_kernels._block_cvar finisher):
    #   CVaR = (sum_G + (an - |G|) v)/an.
    # G is known from `lo` BEFORE the v-pmin resolves, so the local
    # reductions overlap with it; one psum carries both |G| and sum_G
    # (the count is an exact integer <= n_global < 2^24, so the f32
    # ride-along is lossless).
    u = jnp.where(lo >> 31 == 1, lo ^ jnp.uint32(0x80000000), ~lo)
    f_lo = jax.lax.bitcast_convert_type(u, jnp.float32)
    ge = x_local.astype(jnp.float32) >= f_lo[..., None]
    c_local = jnp.sum(ge, axis=-1).astype(jnp.float32)
    s_local = jnp.sum(jnp.where(ge, x_local.astype(jnp.float32), 0.0),
                      axis=-1)
    cs = jax.lax.psum(jnp.stack([c_local, s_local], axis=-1), axis_name)
    c, s = cs[..., 0], cs[..., 1]
    return ((s + (an - c) * v) / an).astype(x_local.dtype)


def dr_cvar_g_sample_parallel(mesh: Mesh, samples, h, alpha, delta, epsilon,
                              robot_radius, obstacle_radius,
                              batch_axis_spec=P(None, "samples", None)):
    """DR-CVaR g* with the sample axis sharded over the mesh.

    samples: [B, N, 2] with N sharded over mesh axis 'samples';
    h: [B, 2].  Returns g_star [B].  The batch axis B follows
    `batch_axis_spec[0]`: None (default) replicates instances over the
    'data' axis; 'data' shards them (h and the returned g follow),
    which on a multi-host mesh keeps the sample-axis psums strictly
    intra-host (parallel/distributed.py layout rule).

    The math matches ops/halfspace.dr_cvar_g_star exactly (verified in
    tests/test_parallel.py against the single-device closed form and in
    tests/distributed_worker.py on a real 2-process cluster).
    """
    n_global = samples.shape[1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(batch_axis_spec, P(batch_axis_spec[0], None)),
        out_specs=P(batch_axis_spec[0]),
    )
    def kernel(samples_local, h_full):
        s_local = jnp.einsum("bnd,bd->bn", samples_local, h_full,
                             precision=jax.lax.Precision.HIGHEST)
        cvar = _distributed_cvar(-s_local, alpha, n_global, "samples")
        r_tilde = (robot_radius + obstacle_radius) * jnp.linalg.norm(
            h_full, axis=-1)
        return cvar + r_tilde - delta + epsilon / alpha

    return kernel(samples, h)
