"""Chip smoke: the engine's main path once, on an NVIDIA GPU, at the
north-star deployment size, checked against a plain reference.

    python chip_smoke.py [--seed S]          # one card
    python chip_smoke.py --four-cards        # the sharded path, four cards

One card runs, for each of the rank1 (4 B/entry) and packed (12 B/entry)
layouts, 1,024 replicas on a ring with 2^20 slots each and 2^16 keys fed
by 2^20 writes per load, through ``PeerNetworkSim``:

1. ``intern_batch`` + ``put_bulk`` (ingest), then ``run_until_converged``;
2. a fresh load, then ``reconcile()``;
3. a fresh load, then ``fast_forward(P/2 + 1)``;
4. ``tables_equal``, 10^5 ``get_bulk`` point reads, ``equals``/``range``.

Then the served path: a writer db peer floods a few thousand writes over
real TCP into a serving peer whose live bridge mirrors them into the
engine, and a ``ReplicaView`` answers queries.

``--four-cards`` runs only the peer axis sharded over four devices
(4,096 replicas × 2^20 slots, packed: 51.5 GB in all, 12.9 GB per card)
through the shard_map convergence loop and reconcile.

The reference: in reference mode, numeric values on a connected ring
converge every replica to the per-key maximum of all values written to
that key, so ``np.maximum.at`` over every write made so far is the
expected state (exact: the values are integers held in float64).

Every phase prints one ``PHASE {...}`` line: its wall time (ending in
``block_until_ready``), its programs' compile time (set-up, compiled
ahead of the timed call), ``peak_bytes_in_use`` (the process's running
peak) and the programs' ``memory_analysis()``. The last line is the
device summary JSON; it is printed only when every phase passed. Any
failure, or a platform other than ``gpu``, exits nonzero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bullet_tpu.models.netsim import PeerNetworkSim  # noqa: E402

ONE_CARD = dict(peers=1024, slots=1 << 20, keys=1 << 16, writes=1 << 20)
FOUR_CARDS = dict(peers=4096, slots=1 << 20, keys=1 << 16, writes=1 << 20)
POINT_READS = 100_000
SERVED_WRITES = 3000


class SmokeFailure(AssertionError):
    """A comparison against the reference (or a contract) did not hold."""


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------- reference


class PerKeyMax:
    """Per-key maximum of every value written so far (-1 = never
    written; every written value is ≥ 0)."""

    def __init__(self, keys: int) -> None:
        self.max = np.full(keys, -1.0)

    def add(self, key_idx: np.ndarray, values: np.ndarray) -> None:
        np.maximum.at(self.max, key_idx, values)

    def matches(self, got) -> bool:
        got = np.asarray(
            [np.nan if v is None else float(v) for v in got], np.float64
        )
        want = np.where(self.max < 0, np.nan, self.max)
        return bool(np.array_equal(got, want, equal_nan=True))


# ------------------------------------------------------------ measurement


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def memory_analysis(compiled) -> dict:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes")
    return {f: getattr(m, f, None) for f in fields}


def timed(fn, sim):
    """(result, wall seconds) of ``fn()`` ending in block_until_ready."""
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(sim.table)
    return out, time.perf_counter() - t0


def emit(record: dict) -> dict:
    record["peak_bytes_in_use"] = peak_bytes()
    print("PHASE " + json.dumps(record), flush=True)
    return record


# ---------------------------------------------- ahead-of-time compilation


def compile_converge(sim: PeerNetworkSim):
    """The exact program ``run_until_converged`` dispatches (packed
    family), compiled ahead so the timed call pays none of it."""
    from bullet_tpu.ops.packed import gossip_until_converged_packed

    max_rounds = max(2 * sim.topology.diameter + 2, 4)
    return gossip_until_converged_packed.lower(
        sim.table, jnp.asarray(sim.topology.neighbors), sim.topology.kind,
        max_rounds, spmd_mesh=sim._gossip_mesh(),
        topo_name=sim.topology.name, hub=sim._star_hub(),
    ).compile()


def compile_reconcile(sim: PeerNetworkSim):
    mesh = sim._gossip_mesh()
    if mesh is not None:
        from bullet_tpu.parallel.shardmap_gossip import (
            reconcile_shardmap_packed,
        )

        return reconcile_shardmap_packed.lower(sim.table, mesh).compile()
    from bullet_tpu.ops.packed import reconcile_packed_xla

    return reconcile_packed_xla.lower(sim.table).compile()


def compile_fast_forward(sim: PeerNetworkSim, rounds: int):
    from bullet_tpu.ops.packed import ring_window_packed_xla

    return ring_window_packed_xla.lower(
        sim.table, sim.topology.kind == "ring", rounds
    ).compile()


def aot(compile_fn, *args):
    t0 = time.perf_counter()
    compiled = compile_fn(*args)
    return time.perf_counter() - t0, memory_analysis(compiled)


# ---------------------------------------------------------------- phases


def make_sim(layout: str, peers: int, slots: int, mesh_devices=None):
    return PeerNetworkSim(
        peers, capacity=slots, topology="ring", layout=layout,
        mesh_devices=mesh_devices, use_shard_map=mesh_devices is not None,
    )


def ingest(sim, key_slots, rng, ref: PerKeyMax, writes: int) -> float:
    """One write load: ``writes`` puts of integer-valued floats at random
    peers and keys; the reference sees every one. Returns wall seconds."""
    peers = rng.integers(0, sim.num_peers, writes).astype(np.int32)
    key_idx = rng.integers(0, len(key_slots), writes)
    values = rng.integers(0, 1 << 30, writes).astype(np.float64)
    t0 = time.perf_counter()
    sim.put_bulk(peers, key_slots[key_idx], values)
    wall = time.perf_counter() - t0
    ref.add(key_idx, values)
    return wall


def apply_pending(sim) -> float:
    """Apply the queued load (host pre-reduction + device scatter) with
    ``step(0)``; returns wall seconds."""
    _, wall = timed(lambda: sim.step(0), sim)
    return wall


def check_state(sim, key_slots, ref: PerKeyMax, where: str) -> None:
    """All replicas identical, and every key at a few peers equal to the
    per-key maximum of the writes so far."""
    expect(sim.tables_equal(), f"{where}: replicas differ")
    p = sim.num_peers
    for peer in sorted({0, p // 2, p - 1}):
        expect(ref.matches(sim.get_bulk(peer, key_slots)),
               f"{where}: peer {peer} differs from the per-key max")


def phase_converge(sim, key_slots, rng, ref, writes, label) -> dict:
    t_ingest = ingest(sim, key_slots, rng, ref, writes)
    t_apply = apply_pending(sim)
    compile_s, mem = aot(compile_converge, sim)
    rounds, wall = timed(sim.run_until_converged, sim)
    expect(sim.last_residual == 0, f"converge: residual {sim.last_residual}")
    check_state(sim, key_slots, ref, "converge")
    return emit(dict(phase="converge", **label, ingest_s=t_ingest,
                     apply_s=t_apply, wall_s=wall, rounds=int(rounds),
                     compile_s=compile_s, memory_analysis=mem))


def phase_reconcile(sim, key_slots, rng, ref, writes, label) -> dict:
    t_ingest = ingest(sim, key_slots, rng, ref, writes)
    t_apply = apply_pending(sim)
    compile_s, mem = aot(compile_reconcile, sim)
    _, wall = timed(sim.reconcile, sim)
    check_state(sim, key_slots, ref, "reconcile")
    return emit(dict(phase="reconcile", **label, ingest_s=t_ingest,
                     apply_s=t_apply, wall_s=wall, compile_s=compile_s,
                     memory_analysis=mem))


def phase_fast_forward(sim, key_slots, rng, ref, writes, label) -> dict:
    rounds = sim.num_peers // 2 + 1
    t_ingest = ingest(sim, key_slots, rng, ref, writes)
    t_apply = apply_pending(sim)
    compile_s, mem = aot(compile_fast_forward, sim, rounds)
    residual, wall = timed(lambda: sim.fast_forward(rounds), sim)
    expect(residual == 0, f"fast_forward: residual {residual}")
    check_state(sim, key_slots, ref, "fast_forward")
    return emit(dict(phase="fast_forward", **label, ingest_s=t_ingest,
                     apply_s=t_apply, wall_s=wall, rounds=rounds,
                     compile_s=compile_s, memory_analysis=mem))


def phase_reads(sim, key_slots, rng, ref, reads, label) -> dict:
    """Point reads, one equals and one range query, against the
    reference."""
    peers = rng.integers(0, sim.num_peers, reads).astype(np.int32)
    key_idx = rng.integers(0, len(key_slots), reads)
    sim.get_bulk(peers[:64], key_slots[key_idx[:64]])  # compile (set-up)
    t0 = time.perf_counter()
    got = sim.get_bulk(peers, key_slots[key_idx])
    t_get = time.perf_counter() - t0
    sub = PerKeyMax(reads)
    sub.max = ref.max[key_idx]
    expect(sub.matches(got), "get_bulk differs from the per-key max")

    written = np.flatnonzero(ref.max >= 0)
    probe = float(ref.max[written[0]])
    want_eq = sorted(
        f"g/k{i}" for i in written if ref.max[i] == probe
    )
    lo, hi = float(np.quantile(ref.max[written], 0.25)), float(
        np.quantile(ref.max[written], 0.75))
    want_rg = sorted(
        f"g/k{i}" for i in written if lo <= ref.max[i] <= hi
    )
    sim.equals(0, "g", probe), sim.range(0, "g", lo, hi)  # compile
    t0 = time.perf_counter()
    eq = sim.equals(sim.num_peers - 1, "g", probe)
    t_eq = time.perf_counter() - t0
    t0 = time.perf_counter()
    rg = sim.range(sim.num_peers - 1, "g", lo, hi)
    t_rg = time.perf_counter() - t0
    expect(eq == want_eq, "equals differs from the reference")
    expect(rg == want_rg, "range differs from the reference")
    return emit(dict(phase="reads", **label, get_bulk_s=t_get,
                     reads=reads, equals_s=t_eq, range_s=t_rg,
                     range_hits=len(rg)))


def run_engine(layout: str, peers: int, slots: int, keys: int, writes: int,
               seed: int, reads: int = POINT_READS) -> list:
    """Every engine phase for one layout on one device."""
    label = dict(layout=layout, peers=peers, slots=slots, keys=keys,
                 writes=writes)
    rng = np.random.default_rng(seed)
    ref = PerKeyMax(keys)
    sim = make_sim(layout, peers, slots)
    t0 = time.perf_counter()
    key_slots = sim.host.intern_batch([f"g/k{i}" for i in range(keys)])
    t_intern = time.perf_counter() - t0
    # apply-program compiles for every batch bucket up to one load
    t0 = time.perf_counter()
    sim.warm_apply_buckets(writes)
    warm_s = time.perf_counter() - t0
    records = [emit(dict(phase="setup", **label, intern_s=t_intern,
                         apply_compile_s=warm_s))]
    records.append(phase_converge(sim, key_slots, rng, ref, writes, label))
    records.append(phase_reconcile(sim, key_slots, rng, ref, writes, label))
    records.append(
        phase_fast_forward(sim, key_slots, rng, ref, writes, label))
    records.append(phase_reads(sim, key_slots, rng, ref, reads, label))
    return records


def run_sharded(devices: int, peers: int, slots: int, keys: int,
                writes: int, seed: int) -> list:
    """The peer axis sharded over ``devices``: converge and reconcile
    (packed) through the shard_map loop, against the reference."""
    label = dict(layout="packed", peers=peers, slots=slots, keys=keys,
                 writes=writes, devices=devices)
    rng = np.random.default_rng(seed)
    ref = PerKeyMax(keys)
    sim = make_sim("packed", peers, slots, mesh_devices=devices)
    key_slots = sim.host.intern_batch([f"g/k{i}" for i in range(keys)])
    sim.warm_apply_buckets(writes)
    expect(all(len(f.devices()) == devices for f in sim.table),
           f"table not sharded over {devices} devices")
    records = [phase_converge(sim, key_slots, rng, ref, writes, label)]
    records.append(phase_reconcile(sim, key_slots, rng, ref, writes, label))
    expect(all(len(f.devices()) == devices for f in sim.table),
           "table left its mesh")
    return records


def run_served(writes: int) -> dict:
    """Writer db peer → real TCP → serving peer → live bridge → engine
    replica → ReplicaView queries, checked against the written data."""
    import bullet_tpu as bt
    from bullet_tpu.models.bridge import attach_live_bridge

    def wait_for(pred, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return False

    sim = PeerNetworkSim(2, capacity=1 << 15, topology="ring", layout="rank1")
    serving = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                         "connect_sync_delay": 600})
    writer = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                        "peers": [f"tcp://127.0.0.1:{serving.network.port}"],
                        "connect_sync_delay": 600})
    handle = attach_live_bridge(serving, sim, peer=0)
    view = handle.view()
    try:
        t0 = time.perf_counter()
        sim.warm_apply_buckets(1 << 16)
        warm_s = time.perf_counter() - t0
        expect(wait_for(lambda: serving.network.peers and writer.network.peers),
               "served: peers did not connect")
        t0 = time.perf_counter()
        for i in range(writes):
            writer.get(f"cat/item{i:05d}").put(
                {"price": float(i % 1000),
                 "tier": "gold" if i % 4 == 0 else "std"})
        expect(wait_for(lambda: len(serving.store.get("cat", {})) == writes),
               "served: flood did not finish")
        wire_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gold = view.count("cat", "tier", "gold")
        lag_s = time.perf_counter() - t0
        expect(gold == (writes + 3) // 4, f"served: count {gold}")
        lat = {"equals": [], "range": [], "count": []}
        for _ in range(30):
            for name, q in (
                ("equals", lambda: view.equals("cat", "tier", "gold")),
                ("range", lambda: view.range("cat", "price", 100.0, 200.0)),
                ("count", lambda: view.count("cat", "tier", "std")),
            ):
                t0 = time.perf_counter()
                q()
                lat[name].append(time.perf_counter() - t0)
        want_eq = sorted(f"cat/item{i:05d}" for i in range(0, writes, 4))
        want_rg = sorted(f"cat/item{i:05d}" for i in range(writes)
                         if 100 <= i % 1000 <= 200)
        expect(view.equals("cat", "tier", "gold") == want_eq,
               "served: equals differs")
        expect(view.range("cat", "price", 100.0, 200.0) == want_rg,
               "served: range differs")
        rec = dict(phase="served", writes=writes, apply_compile_s=warm_s,
                   wire_writes_per_s=writes / wire_s, mirror_lag_s=lag_s)
        for name, v in lat.items():
            rec[f"{name}_p50_ms"] = float(np.percentile(v, 50)) * 1e3
            rec[f"{name}_p95_ms"] = float(np.percentile(v, 95)) * 1e3
        return emit(rec)
    finally:
        handle.detach()
        serving.close()
        writer.close()


# ------------------------------------------------------------------ main


def card_name_and_power() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi in a child
    process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the peer axis sharded over 4 cards")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from bullet_tpu import native
    from bullet_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    lib = native.load()
    print(f"native host library loaded: {lib is not None}", flush=True)
    if lib is None:
        print("chip_smoke: the native host library did not load",
              file=sys.stderr)
        return 3
    card = card_name_and_power()
    print(f"card: {card}", flush=True)

    if args.four_cards:
        run_sharded(4, seed=args.seed, **FOUR_CARDS)
    else:
        for layout in ("rank1", "packed"):
            run_engine(layout, seed=args.seed, **ONE_CARD)
        run_served(SERVED_WRITES)

    print(f"card (name, power.limit): {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
