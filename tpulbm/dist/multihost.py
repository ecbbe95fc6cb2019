"""Multi-host (DCN) scaffolding: process-group init, mesh-over-hosts
construction, and host-0 output gathering.

The reference's multi-node story is a PBS launcher + MPI environment knobs
(mpi_submit:1-64, env.sh:4-9: 4 nodes x ppn=16, hostfile, async-progress).
The counterpart here is ``jax.distributed``: one process per host, all
devices visible as one global ``jax.devices()`` list, collectives riding the
host's own links (NVLink between the cards of a host) within a host and the
network (DCN) across hosts. The launcher equivalent is
``scripts/launch_multihost.sh``.

Design notes:

- ``global_ring_mesh`` orders the 1-D mesh so each host's devices are
  contiguous. The halo ring then crosses DCN only at host boundaries —
  2 x (hosts) boundary rows per K steps — exactly how the reference's row
  decomposition confines inter-node traffic to rank boundaries
  (d2q9-bgk.c:834-862).
- Output gathering mirrors the reference's rank-ordered sequential append
  (d2q9-bgk.c:1049-1122): every process contributes its shard, process 0
  writes the file.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from tpulbm.dist.mesh import AXIS


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize the JAX process group. Returns True if multi-process.

    With no arguments, reads the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``TPULBM_COORDINATOR``, ``TPULBM_NUM_PROCS``,
    ``TPULBM_PROC_ID``); on a cluster whose scheduler JAX recognises,
    ``jax.distributed.initialize()`` detects everything by itself and the env
    vars are unnecessary. No-ops when single-process (num_processes == 1 or
    nothing configured).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "TPULBM_COORDINATOR", os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if num_processes is None and os.environ.get("TPULBM_NUM_PROCS"):
        num_processes = int(os.environ["TPULBM_NUM_PROCS"])
    if process_id is None and os.environ.get("TPULBM_PROC_ID"):
        process_id = int(os.environ["TPULBM_PROC_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False  # single-process run; nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count() > 1


def global_ring_mesh(axis_name: str = AXIS) -> Mesh:
    """1-D mesh over ALL devices (all hosts), host-contiguous.

    ``jax.devices()`` already enumerates devices grouped by process; this
    asserts that invariant (so the ring's DCN crossings stay at host
    boundaries) rather than silently building a ring that ping-pongs across
    hosts every hop.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis_name,))


def process_mesh_info() -> dict:
    """Shape of the run: processes, devices, this process's slot."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def gather_to_host(arr) -> Optional[np.ndarray]:
    """Gather a (possibly cross-host sharded) array to process 0.

    Returns the full ndarray on process 0 and None elsewhere. Single-process
    arrays short-circuit to ``np.asarray``. The multi-host path replicates
    via ``multihost_utils.process_allgather`` (one DCN all-gather — the
    analog of the reference's serialized rank-ordered append,
    d2q9-bgk.c:1049-1122, without the size-count barriers).
    """
    if jax.process_count() == 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(arr, tiled=True)
    return np.asarray(gathered) if jax.process_index() == 0 else None


def is_output_process() -> bool:
    return jax.process_index() == 0
