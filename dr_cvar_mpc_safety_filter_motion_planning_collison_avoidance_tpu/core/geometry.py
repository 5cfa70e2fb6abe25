"""Geometric primitives for collision avoidance (vectorized, jit-safe).

Counterpart of reference core/geometry.py:6-75.  All functions
accept batched inputs (leading axes broadcast) and avoid data-dependent
Python control flow so they trace cleanly under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-10


def support_function_circle(direction, radius):
    """Support function of a circle: r * ||d||, 0 for ~zero directions.

    Reference core/geometry.py:6-20.
    """
    norm = jnp.linalg.norm(direction, axis=-1)
    return jnp.where(norm < _EPS, 0.0, radius * norm)


def minkowski_difference_circle_circle(radius_a, radius_b):
    """Combined radius of two circles (reference core/geometry.py:22-33)."""
    return radius_a + radius_b


def compute_separating_vector(ego_pos, obstacle_pos):
    """Unit vector from ego toward obstacle; [1, 0] if nearly coincident.

    Reference core/geometry.py:35-53 including its degenerate fallback.
    Broadcasts over leading axes; last axis is the spatial dimension.
    """
    diff = obstacle_pos - ego_pos
    norm = jnp.linalg.norm(diff, axis=-1, keepdims=True)
    fallback = jnp.zeros_like(diff).at[..., 0].set(1.0)
    safe_norm = jnp.where(norm < _EPS, 1.0, norm)
    return jnp.where(norm < _EPS, fallback, diff / safe_norm)


def signed_distance(obstacle_pos, h, g_tilde):
    """Paper Eq. 3 signed distance: -(h . p + g_tilde).

    Reference core/geometry.py:55-75 (its `ego_pos` argument is unused
    there too).  Negative means no collision.
    """
    return -(jnp.sum(h * obstacle_pos, axis=-1) + g_tilde)
