"""Multi-host process-group glue.

The reference has no multi-node story at all (SURVEY.md §2.4); this is the
JAX one: `jax.distributed.initialize` builds the process group, with ONE
process per host that drives all of that host's devices (a second JAX
process on a card would fail for want of memory), every process
contributes its local devices to one global mesh, and the jitted sharded
matcher from dist/sharding.py runs unchanged — collectives go over
NVLink within a host and the network across hosts.

Per-host corpus feeding: each process places only its own shard slice
(`host_shard_slice`) and the global array is assembled logically via
`jax.make_array_from_single_device_arrays`.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import AXIS, ShardedMatcher, make_data_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime (no-op if single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh():
    """1-D data mesh over every chip in the job (all hosts)."""
    return make_data_mesh(devices=jax.devices())


def host_shard_slice(n_total: int, shard_len: int) -> tuple[int, int]:
    """[start, stop) byte range of the global corpus this process must load.

    With a 1-D mesh over jax.devices(), device d owns bytes
    [d*shard_len, (d+1)*shard_len); a process owns the union of its local
    devices' ranges (contiguous for the standard device order).
    """
    local = jax.local_devices()
    all_devs = jax.devices()
    idx = sorted(all_devs.index(d) for d in local)
    start = idx[0] * shard_len
    stop = (idx[-1] + 1) * shard_len
    return min(start, n_total), min(stop, n_total)


def put_host_shards(matcher: ShardedMatcher, local_bytes: np.ndarray,
                    global_len_padded: int) -> jax.Array:
    """Assemble the logically-global sharded input from per-process slices."""
    mesh = matcher.mesh
    sharding = NamedSharding(mesh, P(AXIS))
    shard_len = global_len_padded // mesh.devices.size
    local = jax.local_devices()
    all_devs = list(mesh.devices.flat)
    pieces = []
    off = 0
    for d in sorted(local, key=all_devs.index):
        piece = local_bytes[off : off + shard_len]
        pieces.append(jax.device_put(piece, d))
        off += shard_len
    return jax.make_array_from_single_device_arrays(
        (global_len_padded,), sharding, pieces
    )
