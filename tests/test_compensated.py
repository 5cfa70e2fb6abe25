"""Compensated float32 products (ops/compensated.py) against exact
float64 sums of the same float32 operands."""

import jax.numpy as jnp
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops.compensated import (
    dot2, sum2)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("width", [3, 4, 5, 17])
def test_sum2_recovers_what_cancellation_loses(width):
    """1e8 + 1 - 1e8 (padded out to `width` with zeros) is 1 exactly; a
    plain float32 sum loses the 1."""
    x = np.zeros((2, width), np.float32)
    x[:, :3] = [1e8, 1.0, -1e8]
    got = np.asarray(sum2(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.ones(2, np.float32))


@pytest.mark.parametrize("cols", [1, 8, 60])
def test_dot2_cancelling_products_round_about_once(cols):
    """Terms of ~500 whose sum is cancelled down to O(1) by `add`: dot2
    stays within a few roundings of the exact result, far below the
    float32 rounding of the terms themselves."""
    rng = np.random.default_rng(cols)
    m = (500.0 * rng.normal(size=(6, cols))).astype(np.float32)
    v = rng.normal(size=cols).astype(np.float32)
    add = (-(m.astype(np.float64) @ v) + rng.normal(size=6)).astype(
        np.float32)
    exact = m.astype(np.float64) @ v.astype(np.float64) + add
    got = np.asarray(dot2([jnp.asarray(m)], [jnp.asarray(v)],
                          add=[jnp.asarray(add)]), np.float64)
    scale = np.abs(m.astype(np.float64) * v).sum(axis=1) + np.abs(add)
    bound = 4 * EPS32 * np.abs(exact) + 1e-2 * EPS32 * scale
    assert (np.abs(got - exact) <= bound).all(), (got - exact, bound)


def test_dot2_sums_blocks_together():
    """Several blocks share one summation: [M1 | M2] @ [v1; v2]."""
    rng = np.random.default_rng(3)
    m1 = rng.normal(size=(4, 5)).astype(np.float32)
    m2 = rng.normal(size=(4, 3)).astype(np.float32)
    v1 = rng.normal(size=5).astype(np.float32)
    v2 = rng.normal(size=3).astype(np.float32)
    got = dot2([jnp.asarray(m1), jnp.asarray(m2)],
               [jnp.asarray(v1), jnp.asarray(v2)])
    exact = (np.hstack([m1, m2]).astype(np.float64)
             @ np.concatenate([v1, v2]).astype(np.float64))
    np.testing.assert_allclose(np.asarray(got), exact, rtol=4 * EPS32,
                               atol=1e-6)


def test_dot2_float64_is_plain_product():
    rng = np.random.default_rng(4)
    m = jnp.asarray(rng.normal(size=(3, 4)))
    v = jnp.asarray(rng.normal(size=4))
    a = jnp.asarray(rng.normal(size=3))
    np.testing.assert_array_equal(np.asarray(dot2([m], [v], add=[a])),
                                  np.asarray(m @ v + a))
