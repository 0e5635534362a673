"""Multi-host orchestration: one mesh over the devices of several hosts
(BASELINE config 5).

The reference tops out at one FPGA with a host poking ports; here more
throughput means more devices, across hosts.  Everything in
parallel/shard.py is mesh-shape-agnostic — this module only adds process
bootstrap and host-local data feeding so the same shard_map programs run
on any number of hosts unchanged:

  * initialize(): jax.distributed.initialize() when the environment names
    a coordinator (no-op on a single host)
  * global_mesh(): 1-D "dp" mesh over ALL devices of all processes
  * host_shard_bounds(): which chunks this process should materialize —
    with jax.make_array_from_single_device_arrays the per-host feeding
    pattern.

Single-host degenerates to parallel/shard.py exactly; the two-process
path is tested on virtual CPU devices (tests/test_multihost.py).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize() -> bool:
    """Initialize jax.distributed if a multi-process environment is
    detected (COORDINATOR_ADDRESS or JAX_COORDINATOR_ADDRESS, with
    NUM_PROCESSES and PROCESS_ID).  Returns True if the process is one of
    several.

    Must run before anything touches the XLA backend, so the coordinator
    env is checked FIRST — jax.process_count() itself would initialize
    the backend and poison jax.distributed.initialize()."""
    coord = os.environ.get("COORDINATOR_ADDRESS") or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coord:
        from jax._src import distributed as _dist

        if _dist.global_state.client is None:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(os.environ["NUM_PROCESSES"]),
                process_id=int(os.environ["PROCESS_ID"]),
            )
        return True
    return jax.process_count() > 1


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_shard_bounds(nchunks: int) -> tuple[int, int]:
    """[start, end) chunk range this process must materialize when the
    chunk batch is sharded over the global mesh."""
    pc, pid = jax.process_count(), jax.process_index()
    per = -(-nchunks // pc)
    return min(pid * per, nchunks), min((pid + 1) * per, nchunks)


def make_global_batch(local_chunks: np.ndarray, nchunks_global: int, mesh: Mesh, axis: str = "dp"):
    """Assemble a process-local chunk array into a globally-sharded jax
    Array (each host contributes only its shard; no host holds the full
    batch)."""
    sharding = NamedSharding(mesh, P(axis))
    shape = (nchunks_global,) + tuple(local_chunks.shape[1:])
    local_devices = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    per_dev = -(-local_chunks.shape[0] // max(len(local_devices), 1))
    arrays = []
    for i, d in enumerate(local_devices):
        piece = local_chunks[i * per_dev : (i + 1) * per_dev]
        arrays.append(jax.device_put(piece, d))
    return jax.make_array_from_single_device_arrays(shape, sharding, arrays)
