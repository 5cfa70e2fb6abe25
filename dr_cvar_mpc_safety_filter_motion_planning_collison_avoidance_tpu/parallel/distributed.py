"""Multi-host execution: jax.distributed init + host-aware mesh layout.

The reference is a single process (SURVEY.md section 2 parallelism
inventory: none).  At scale, this engine's sweeps span several hosts:
the GPUs of one host are joined all to all by NVLink, and hosts talk
over the network.  The mesh layout rule:

  * `data` axis (independent problem instances -- MC runs, sweep cells,
    scenario fleets) lies over HOSTS.  Instances are embarrassingly
    parallel, so the only cross-host traffic is the final metric gather.
  * `samples` axis (the N Monte-Carlo samples inside one DR-CVaR
    program) lies over each host's LOCAL devices.  Its psum-based order
    statistics (parallel/sample_parallel.py) are latency-sensitive and
    must stay on NVLink, never cross the network.

Single-process (virtual-device or single-chip) runs use the same layout
helpers with `n_hosts` emulating process boundaries, so multi-host
programs are testable on one machine (tests/test_distributed.py spawns
a REAL 2-process Gloo-backed CPU cluster as well).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def to_global_array(x, sharding: NamedSharding):
    """Turn a host value (same on every process) into a global jax.Array
    with `sharding`, which may span processes.

    Multi-process jit rejects raw numpy inputs with non-replicated
    shardings; this is the documented `make_array_from_callback` path
    (each process materializes only its addressable shards).
    """
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> bool:
    """Initialize the JAX distributed runtime for multi-host execution.

    Thin, idempotent wrapper over `jax.distributed.initialize`.  Pass
    the coordinator address, process count and process id explicitly
    unless a cluster environment the runtime recognises provides them.
    Returns True when a multi-process runtime is (now) active, False for
    single-process.

    Must be called before any other JAX API touches the backend.
    """
    if num_processes is not None and num_processes <= 1 \
            and coordinator_address is None:
        return False
    already = jax.distributed.is_initialized()
    if not already:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
        jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def make_multihost_mesh(n_hosts: int | None = None,
                        devices_per_host: int | None = None,
                        devices=None) -> Mesh:
    """Build the host-aware mesh: 'data' over hosts, 'samples' over the
    devices inside one host.

    In a real multi-process runtime (jax.process_count() > 1) the host
    grouping comes from each device's `process_index`, so rows of the
    mesh ARE hosts and the `samples` axis stays inside one host's
    NVLink-connected devices.  In a single process, `n_hosts` emulates the
    layout by slicing the flat device list into contiguous host-sized
    groups (virtual CPU devices / dry runs).

    Returns Mesh(axis_names=('data', 'samples')) of shape
    [n_hosts, devices_per_host].
    """
    if devices is None:
        devices = jax.devices()
    if jax.process_count() > 1:
        devices = sorted(devices, key=lambda d: (d.process_index, d.id))
        n_real_hosts = len({d.process_index for d in devices})
        if n_hosts is None:
            n_hosts = n_real_hosts
        elif n_hosts != n_real_hosts:
            raise ValueError(
                f"n_hosts={n_hosts} but the runtime has {n_real_hosts} "
                "processes; the data axis must match host boundaries so "
                "sample-axis collectives never cross hosts.")
    elif n_hosts is None:
        n_hosts = 1
    if devices_per_host is None:
        if len(devices) % n_hosts != 0:
            raise ValueError(
                f"{len(devices)} devices do not divide evenly over "
                f"{n_hosts} hosts; pass devices_per_host explicitly or "
                "trim the device list -- silently dropping devices would "
                "hide capacity.")
        devices_per_host = len(devices) // n_hosts
    used = n_hosts * devices_per_host
    if used > len(devices):
        raise ValueError(
            f"mesh needs {used} devices but only {len(devices)} exist")
    grid = np.asarray(devices[:used]).reshape(n_hosts, devices_per_host)
    if jax.process_count() > 1:
        # The module's contract: every mesh row lives inside ONE process
        # so 'samples'-axis collectives never leave the host.
        for row in grid:
            procs = {d.process_index for d in row}
            if len(procs) != 1:
                raise ValueError(
                    "mesh row spans processes "
                    f"{sorted(procs)}: per-host device counts must be "
                    "uniform so the samples axis stays intra-host")
    return Mesh(grid, axis_names=("data", "samples"))
