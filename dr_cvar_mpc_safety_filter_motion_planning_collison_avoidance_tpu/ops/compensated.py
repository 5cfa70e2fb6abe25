"""Compensated float32 matrix-vector products.

The MPC QP's gradient and KKT residuals are sums of terms hundreds of
times larger than their result (|q| ~ 500 against residuals ~ 1e-3), so
a plain float32 product leaves ~1e-4 of rounding in the controls -- the
size of the 1e-4 oracle bound itself.  `dot2` evaluates such products
as if in about twice the working precision:

  * every operand is split exactly into a high half of at most 12
    significant bits and the rest (`_split`), so the products of high
    halves are exact in float32;
  * those exact products are summed by a tree of error-free two-sums,
    the rounding errors carried alongside;
  * the remaining cross terms are 2^-12 smaller and are summed plainly.

Only additions, subtractions and exact products need care, so an FMA
contraction by the compiler cannot change the result.  Other dtypes
(float64) take the plain product.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _split(x):
    """x = hi + lo exactly, hi and lo each with <= 12 significant bits
    (hi keeps the top 11 stored mantissa bits)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32) & jnp.uint32(
        0xFFFFF000)
    hi = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return hi, x - hi


def _two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def sum2(x):
    """Compensated sum over the last axis: the halves are folded onto
    each other by two-sums (contiguous slices, no gathers)."""
    width = 1 << max(x.shape[-1] - 1, 0).bit_length()
    pad = [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])]
    x = jnp.pad(x, pad)
    err = jnp.zeros_like(x)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x, e = _two_sum(x[..., :half], x[..., half:])
        err = err[..., :half] + err[..., half:] + e
    return (x + err)[..., 0]


def dot2(mats, vecs, add=()):
    """sum_k mats[k] @ vecs[k] + sum(add) ([r, c_k] @ [c_k] -> [r]) in
    compensated float32: the exact sum, rounded about once.  All blocks
    share one summation, so their large terms cancel before anything is
    rounded."""
    if vecs[0].dtype != jnp.float32:
        return sum(m @ v for m, v in zip(mats, vecs)) + sum(add)
    terms = [a[:, None] for a in add]
    low = 0.0
    for m, v in zip(mats, vecs):
        mh, ml = _split(m)
        vh, vl = _split(v)
        terms.append(mh * vh)                  # exact products
        low = low + mh @ vl + ml @ v           # 2^-12 of the terms
    return sum2(jnp.concatenate(terms + [low[:, None]], axis=-1))
