"""Obstacle trajectory generation (nominal / Gaussian samples / Laplace
realization).

Counterpart of reference simulation/obstacles.py:7-197.  All
obstacles of a scenario are generated in one shot with stacked array
shapes and counter-based `jax.random` keys, so generation jits, vmaps
over Monte-Carlo runs, and shards over device meshes.

Distributional contract (matching the reference):
  * nominal: constant-velocity rollout of speed * normalize(direction);
    stationary when ||direction|| < 1e-10 (obstacles.py:18-28).
  * samples: nominal + i.i.d. N(0, noise_cov) per (sample, t>=1); all
    samples share the exact start position (obstacles.py:60-77).
  * realization: nominal + i.i.d. Laplace noise with scale
    sqrt(diag(noise_cov)/2) per (t>=1) -- deliberately a DIFFERENT
    distribution than the planner's Gaussian belief; this is the
    distributional-robustness stress test (obstacles.py:79-113).

RNG streams are `jax.random` (threefry), not NumPy MT19937, so sample
values differ from the reference at equal seeds; parity tests inject
reference-generated samples directly (see SURVEY.md section 7 pillar 3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-10


class ObstacleData(NamedTuple):
    """Stacked obstacle trajectories for one scenario draw.

    nominal:      [n_obs, T+1, 2]
    samples:      [n_obs, n_samples, T+1, 2]
    realization:  [n_obs, T+1, 2]
    """

    nominal: jax.Array
    samples: jax.Array
    realization: jax.Array


def generate_nominal_trajectories(starts, directions, speeds, n_steps: int,
                                  dt: float):
    """Constant-velocity nominal trajectories, [n_obs, n_steps+1, 2].

    Reference simulation/obstacles.py:7-41 (single-integrator rollout,
    closed form here).  Directions are normalized; near-zero directions
    yield stationary obstacles.
    """
    norm = jnp.linalg.norm(directions, axis=-1, keepdims=True)
    unit = jnp.where(norm < _EPS, 0.0, directions / jnp.where(norm < _EPS, 1.0, norm))
    vel = speeds[:, None] * unit                                  # [n_obs, 2]
    t = jnp.arange(n_steps + 1, dtype=starts.dtype)[None, :, None]
    return starts[:, None, :] + t * dt * vel[:, None, :]


@functools.partial(jax.jit, static_argnames=("n_samples",))
def generate_sample_trajectories(key, nominal, n_samples: int, noise_var):
    """Gaussian sample trajectories, [n_obs, n_samples, T+1, 2].

    Reference simulation/obstacles.py:43-77: i.i.d. per-step noise with
    covariance diag(noise_var); the start position (t=0) is shared
    noise-free by all samples.
    """
    n_obs, T1, dim = nominal.shape
    noise = jax.random.normal(key, (n_obs, n_samples, T1, dim), nominal.dtype)
    noise = noise * jnp.sqrt(noise_var)
    noise = noise.at[:, :, 0, :].set(0.0)
    return nominal[:, None, :, :] + noise


@jax.jit
def generate_laplace_realizations(key, nominal, noise_var):
    """Laplace-noised realizations, [n_obs, T+1, 2].

    Reference simulation/obstacles.py:79-113: scale = sqrt(var/2) (so the
    Laplace variance equals the Gaussian belief's), generated there as a
    difference of exponentials -- `jax.random.laplace` is the same law.
    """
    scale = jnp.sqrt(noise_var / 2.0)
    noise = scale * jax.random.laplace(key, nominal.shape, nominal.dtype)
    noise = noise.at[:, 0, :].set(0.0)
    return nominal + noise


@functools.partial(jax.jit, static_argnames=("n_steps", "n_samples"))
def generate_obstacle_scenarios(key, starts, directions, speeds,
                                n_steps: int, dt: float,
                                n_samples: int, noise_var: float = 0.01
                                ) -> ObstacleData:
    """Full scenario draw (reference simulation/obstacles.py:115-197).

    Args:
      key: PRNG key; split internally for samples vs realization.
      starts/directions/speeds: stacked per-obstacle arrays from
        `config.Scenario`.
      n_steps: number of simulation steps (int(sim_time / dt), reference
        obstacles.py:131).
      noise_var: per-axis noise variance (reference obstacles.py:134
        hard-codes 0.01).
    """
    k_samples, k_real = jax.random.split(key)
    nominal = generate_nominal_trajectories(starts, directions, speeds,
                                            n_steps, dt)
    samples = generate_sample_trajectories(k_samples, nominal, n_samples,
                                           noise_var)
    realization = generate_laplace_realizations(k_real, nominal, noise_var)
    return ObstacleData(nominal, samples, realization)
