"""Device-mesh helpers for multi-chip execution.

The reference is single-process/single-thread (SURVEY.md section 2
parallelism inventory: none).  The engine's parallel structure:

  * `data` axis: independent problem instances -- (scenario x MC-run x
    timing-sweep cell x timestep x obstacle) batches shard over chips via
    `NamedSharding`; XLA inserts any needed collectives.
  * `samples` axis: the N Monte-Carlo samples inside one DR-CVaR program
    shard over chips; the solver's reductions become `psum`s
    (parallel/sample_parallel.py).

Collectives are XLA ops over `jax.sharding.Mesh` (NCCL on the GPU).  The
cards of one host are joined all to all by NVLink, so devices are taken
in `jax.devices()` order with no topology-shaped layout.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_samples: int = 1,
              devices=None) -> Mesh:
    """Build a (data, samples) mesh over the available devices.

    Defaults to all devices on the data axis.  n_data * n_samples must
    equal the device count used.
    """
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_samples
    devices = np.asarray(devices[: n_data * n_samples]).reshape(
        n_data, n_samples)
    return Mesh(devices, axis_names=("data", "samples"))


def data_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0
                  ) -> NamedSharding:
    """NamedSharding that splits axis `batch_axis` over the mesh's data
    axis and replicates the rest."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return NamedSharding(mesh, P(*spec))


def shard_batch(pytree, mesh: Mesh, batch_axis: int = 0):
    """Device-put every array of a pytree with its batch axis sharded
    over the mesh's data axis."""
    def put(x):
        return jax.device_put(x, data_sharding(mesh, x.ndim, batch_axis))
    return jax.tree_util.tree_map(put, pytree)


def replicated(pytree, mesh: Mesh):
    """Replicate every leaf across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), pytree)
