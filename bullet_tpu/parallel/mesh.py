"""Device mesh + sharding for the peer axis.

The simulated-peer axis (leading axis of every table array) shards over a
1-D ``jax.sharding.Mesh`` — the engine's equivalent of the reference's
one-OS-process-per-peer deployment (SURVEY §2 "Parallelism"). Everything
downstream is ordinary jit: ``jnp.roll``/gathers over the sharded axis lower
to collective-permutes / all-gathers; nothing in the step functions is
mesh-aware. Multi-host extends the same mesh over DCN via
``jax.distributed.initialize`` — same code path.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PEER_AXIS = "peers"


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (default: all)."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (PEER_AXIS,))


def peer_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (peers) sharded, slots replicated within a shard."""
    return NamedSharding(mesh, PartitionSpec(PEER_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_table(table, mesh: Mesh):
    """Place a TableState with the peer axis sharded over the mesh."""
    sharding = peer_sharding(mesh)
    return type(table)(*(jax.device_put(f, sharding) for f in table))


def pad_peers_to_mesh(num_peers: int, mesh: Mesh) -> int:
    """Smallest peer count ≥ num_peers divisible by the mesh size."""
    n = mesh.devices.size
    return ((num_peers + n - 1) // n) * n
