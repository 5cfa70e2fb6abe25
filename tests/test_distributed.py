"""Multi-host path tests.

Two layers:
  * in-process: host-aware mesh layout helpers on the 8-device virtual
    CPU mesh (host grouping emulated);
  * real 2-process fake cluster: spawns two `distributed_worker.py`
    processes (4 virtual CPU devices each) joined through
    `jax.distributed.initialize` + Gloo, running sample-parallel,
    cross-host data-parallel, and full-pipeline sharded programs
    (SURVEY.md section 5 "Distributed communication backend",
    section 7 step 7).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.parallel import (
    initialize_distributed, make_multihost_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_multihost_mesh_emulated_layout():
    """Single process: n_hosts slices the flat device list into
    contiguous host groups -> (data, samples) = (2, 4)."""
    mesh = make_multihost_mesh(n_hosts=2)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("data", "samples")
    flat = [d.id for d in mesh.devices.reshape(-1)]
    assert flat == sorted(flat)


def test_make_multihost_mesh_default_single_host():
    mesh = make_multihost_mesh()
    assert mesh.devices.shape == (1, 8)


def test_initialize_distributed_single_process_noop():
    """num_processes=1 with no coordinator is a no-op returning False
    (the single-host fast path of a pod-or-laptop entrypoint)."""
    assert initialize_distributed(num_processes=1) is False


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_fake_cluster():
    """Real multi-process runtime: 2 hosts x 4 devices over Gloo."""
    port = _free_port()
    nproc = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "distributed_worker.py"),
             str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("fake cluster timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: cross-host pipeline batch OK" in out
