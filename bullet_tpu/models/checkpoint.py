"""Durable checkpoints for the simulation engine.

The engine analog of the reference's file storage (which is its checkpoint
system — SURVEY §5 "Checkpoint / resume"): device tables + interner state
land in ``state.npz`` + ``meta.json`` under a directory, and
``load_checkpoint`` reconstructs a fully working sim (interners are replayed
in insertion order, which reproduces ids and string ranks exactly).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def save_checkpoint(sim, directory: str, backend: str = "npz") -> None:
    """``backend="npz"`` (default, dependency-free) or ``"orbax"`` (async-
    capable, sharding-aware saves for long-running simulations). The field
    set follows the sim's table layout (dense 7-array or packed 3-array).

    Queued-but-unapplied ops are applied first (a save must not silently
    drop acknowledged puts), and any pending string-rank re-key runs before
    the arrays are captured — load replays the interner to its CURRENT
    ranks, so saving stale khi/klo would permanently corrupt string order
    keys after restore."""
    if any(sim._pending) or sim._pending_bulk:
        sim.step(rounds=0)
    sim._sync_device_state()
    os.makedirs(directory, exist_ok=True)
    fields = sim.table._fields
    extras = {"clock": sim._clock_snapshot()}
    if getattr(sim, "layout", "dense") == "rank1":
        # rank1 stores no vid bits on device: the checkpoint must carry its
        # OWN epoch's rank -> vid inverse so load can decode the stored
        # ranks onto the replayed index's (differently spread) ranks
        sim._sync_rank_index()
        sr, sv = sim.rank_index.inverse_arrays()
        extras["rank_inv_ranks"] = sr.copy()
        extras["rank_inv_vids"] = sv.copy()
    if backend == "orbax":
        import orbax.checkpoint as ocp

        state = {name: f for name, f in zip(fields, sim.table)}
        state.update(extras)
        with ocp.StandardCheckpointer() as ckptr:
            ckptr.save(os.path.join(os.path.abspath(directory), "orbax"), state)
            ckptr.wait_until_finished()
    else:
        arrays = {name: np.asarray(f) for name, f in zip(fields, sim.table)}
        arrays.update(extras)
        np.savez_compressed(os.path.join(directory, "state.npz"), **arrays)

    host = sim.host
    # skip absent/null sentinels; one vectorized pass (per-vid decode cost
    # ~0.4 s per 100k lazy numbers)
    values = host.values.decode_batch(
        np.arange(2, len(host.values))
    ).tolist()
    meta = {
        "format": "bullet-tpu-checkpoint",
        "version": 1,
        "backend": backend,
        "num_peers": sim.num_peers,
        "capacity": sim.capacity,
        "mode": sim.mode,
        "layout": getattr(sim, "layout", "dense"),
        "tick": sim.tick,
        "topology": {
            "name": sim.topology.name,
            "kind": sim.topology.kind,
            "diameter": sim.topology.diameter,
            "neighbors": sim.topology.neighbors.tolist(),
        },
        "paths": [sim.host.paths.path(i) for i in range(len(sim.host.paths))],
        "values": values,
        "stats": sim.stats,
    }
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(directory: str, mesh_devices: Optional[int] = None):
    from ..parallel.topology import Topology
    from .netsim import PeerNetworkSim
    import jax.numpy as jnp

    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "bullet-tpu-checkpoint":
        raise ValueError("not a bullet-tpu checkpoint")

    t = meta["topology"]
    topology = Topology(
        name=t["name"],
        num_peers=meta["num_peers"],
        neighbors=np.asarray(t["neighbors"], dtype=np.int32),
        kind=t["kind"],
        diameter=t["diameter"],
    )
    sim = PeerNetworkSim(
        meta["num_peers"],
        capacity=meta["capacity"],
        topology=topology,
        mode=meta["mode"],
        mesh_devices=mesh_devices,
        layout=meta.get("layout", "dense"),
    )
    # replay interners in insertion order -> identical ids and ranks
    for path in meta["paths"]:
        sim.host.intern_path(path)
    for value in meta["values"]:
        sim.host.encode_value(value)
    sim.host.needs_rekey = False

    fields = sim.table._fields
    if meta.get("backend") == "orbax":
        import orbax.checkpoint as ocp

        template = {name: np.asarray(f) for name, f in zip(fields, sim.table)}
        template["clock"] = sim._clock_snapshot()
        if meta.get("layout") == "rank1":
            # the replayed index holds the same value count, so the saved
            # inverse arrays restore into same-shaped templates
            sim._sync_rank_index()
            sr, sv = sim.rank_index.inverse_arrays()
            template["rank_inv_ranks"] = sr
            template["rank_inv_vids"] = sv
        with ocp.StandardCheckpointer() as ckptr:
            data = ckptr.restore(
                os.path.join(os.path.abspath(directory), "orbax"), template
            )
    else:
        data = np.load(os.path.join(directory, "state.npz"))
    sim.table = type(sim.table)(*(jnp.asarray(data[name]) for name in fields))
    if meta.get("layout") == "rank":
        # gap ranks are a function of insertion HISTORY, not just the value
        # set — a fresh one-batch replay spreads them differently than the
        # original incremental inserts. Rebuild the index, then re-gather
        # every stored rank from the fresh vid -> rank LUT (cv carries the
        # vid, so stored rank values are disposable).
        from ..ops.rank import rekey_rank

        sim._sync_rank_index()
        sim.rank_index.needs_rekey = False
        sim.table = rekey_rank(
            sim.table, jnp.asarray(sim.rank_index.rank_map())
        )
    elif meta.get("layout") == "rank1":
        # same replay-respread mismatch, but the stored ranks decode
        # through the CHECKPOINT's saved inverse instead of a vid column
        from ..ops.rank import rekey_rank1

        sim._sync_rank_index()
        sim.rank_index.needs_rekey = False
        osr = np.asarray(data["rank_inv_ranks"])
        osv = np.asarray(data["rank_inv_vids"])
        if len(osr):
            sim.table = rekey_rank1(
                sim.table, jnp.asarray(osr), jnp.asarray(osv),
                jnp.asarray(sim.rank_index.rank_map()),
            )
    if sim.mesh is not None:
        from ..parallel.mesh import shard_table

        sim.table = shard_table(sim.table, sim.mesh)
    sim._clock = data["clock"].copy()
    sim._clock_list = sim._clock.tolist()
    sim.tick = meta["tick"]
    sim.stats.update(meta.get("stats", {}))
    return sim
