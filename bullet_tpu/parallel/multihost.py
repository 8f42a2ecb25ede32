"""Multi-host (DCN) support.

One process per host, each seeing its local devices;
``jax.distributed.initialize`` stitches them into one global device list, and
the same 1-D peer mesh then spans hosts — gossip shifts ride the intra-host
links within a host and the network across hosts, with no engine code
changes (the design SURVEY §2 calls the NCCL/MPI-equivalent slot).

Typical launch (same script on every host):

    from bullet_tpu.parallel.multihost import initialize_multihost, global_mesh
    initialize_multihost("host0:1234", num_processes=4, process_id=RANK)
    mesh = global_mesh()
    sim = PeerNetworkSim(4096, capacity=1 << 20, topology="ring",
                         mesh_devices=len(jax.devices()))
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import make_mesh


def initialize_multihost(
    coordinator_address: str,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the global JAX runtime (idempotent per process)."""
    try:
        if jax.distributed.is_initialized():
            return
    except AttributeError:  # older jax without is_initialized
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh():
    """1-D peer mesh over every device of every participating host."""
    return make_mesh()


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
