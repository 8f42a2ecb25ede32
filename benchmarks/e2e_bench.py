"""End-to-end engine benchmark on the GPU: bulk ingestion → apply → gossip
to convergence, direct reconcile and fast_forward under fresh write loads,
then reads and queries.

Unlike bench.py (one device program), this measures the full
PeerNetworkSim path at the north-star shape: 1,024 peers on a ring, 2^20
slots each, 2^16 keys fed by 2^20 writes per load. Every timing ends in
``block_until_ready``; compilation is timed separately as set-up. Needs a
GPU: it exits nonzero when JAX finds none.

Usage: python benchmarks/e2e_bench.py [--layout packed|rank|rank1]
                                      [--iters 5] [--seed 0]
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO_ROOT)

import jax  # noqa: E402

from bullet_tpu.models.netsim import PeerNetworkSim  # noqa: E402
from bullet_tpu.parallel import topology as topo  # noqa: E402
from bullet_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def _timed(fn, sim):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(sim.table)
    return out, time.perf_counter() - t0


def _pctl(samples, q):
    return float(np.percentile(np.asarray(samples), q))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="packed",
                    choices=["packed", "rank", "rank1"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        sys.exit(f"e2e_bench: needs a GPU, JAX found {dev0.platform}")
    enable_compile_cache()

    num_peers, capacity, keys, writes = 1024, 1 << 20, 1 << 16, 1 << 20
    out = {"platform": dev0.platform, "device_kind": dev0.device_kind,
           "device_count": len(jax.devices()), "num_peers": num_peers,
           "capacity": capacity, "keys": keys, "writes": writes,
           "layout": args.layout}
    sim = PeerNetworkSim(num_peers, capacity=capacity,
                         topology=topo.ring(num_peers), layout=args.layout)

    t0 = time.perf_counter()
    slots = sim.host.intern_batch([f"g/k{i}" for i in range(keys)])
    out["intern_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)

    def load():
        t0 = time.perf_counter()
        sim.put_bulk(
            rng.integers(0, num_peers, writes).astype(np.int32),
            slots[rng.integers(0, keys, writes)],
            rng.integers(0, 1 << 30, writes).astype(np.float64),
        )
        return time.perf_counter() - t0

    # set-up: compile the apply ladder and the convergence loop on a
    # first load (converging it once), then time a second load
    t0 = time.perf_counter()
    sim.warm_apply_buckets(writes)
    load()
    sim.run_until_converged()
    jax.block_until_ready(sim.table)
    out["setup_compile_and_first_converge_s"] = time.perf_counter() - t0

    out["ingest_s"] = load()
    out["ingest_ops_per_s"] = writes / out["ingest_s"]
    rounds, out["converge_s"] = _timed(sim.run_until_converged, sim)
    out["rounds"] = rounds
    out["converge_residual"] = sim.last_residual

    # reconcile: fresh loads, each timed with its apply
    _timed(sim.reconcile, sim)  # compile on the converged table (no-op)
    rec = []
    for _ in range(args.iters):
        load()
        rec.append(_timed(sim.reconcile, sim)[1])
    out["reconcile_s_p50"] = _pctl(rec, 50)
    out["reconcile_s_p90"] = _pctl(rec, 90)
    out["reconcile_s_all"] = rec
    out["reconcile_join_s"] = _timed(sim.reconcile, sim)[1]

    # fast_forward: jump exactly diameter + 1 rounds after fresh loads
    ff_rounds = num_peers // 2 + 1
    _timed(lambda: sim.fast_forward(ff_rounds), sim)  # compile
    ff, residual = [], None
    for _ in range(args.iters):
        load()
        residual, dt = _timed(lambda: sim.fast_forward(ff_rounds), sim)
        ff.append(dt)
    out["fast_forward_rounds"] = ff_rounds
    out["fast_forward_residual"] = int(residual)
    out["fast_forward_s_p50"] = _pctl(ff, 50)
    out["fast_forward_s_p90"] = _pctl(ff, 90)
    out["fast_forward_s_all"] = ff
    out["fast_forward_jump_s"] = _timed(
        lambda: sim.fast_forward(ff_rounds), sim)[1]

    t0 = time.perf_counter()
    out["tables_equal"] = bool(sim.tables_equal())
    out["verify_s"] = time.perf_counter() - t0

    probe = sim.get(0, "g/k0")
    sim.equals(0, "g", probe)  # compile
    t0 = time.perf_counter()
    out["equals_hits"] = len(sim.equals(0, "g", probe))
    out["equals_s"] = time.perf_counter() - t0
    lo, hi = 1 << 29, 1 << 31
    sim.range(0, "g", lo, hi)  # compile
    t0 = time.perf_counter()
    out["range_hits"] = len(sim.range(0, "g", lo, hi))
    out["range_s"] = time.perf_counter() - t0

    reads = 100_000
    r_peers = rng.integers(0, num_peers, reads).astype(np.int32)
    r_slots = slots[rng.integers(0, keys, reads)]
    sim.get_bulk(r_peers[:128], r_slots[:128])  # compile
    t0 = time.perf_counter()
    vals = sim.get_bulk(r_peers, r_slots)
    out["get_bulk_s"] = time.perf_counter() - t0
    out["get_bulk_reads_per_s"] = reads / out["get_bulk_s"]
    assert len(vals) == reads

    print(json.dumps(out))
    if not (out["tables_equal"] and out["converge_residual"] == 0
            and out["fast_forward_residual"] == 0):
        sys.exit("e2e_bench: the engine did not reach its fixed point")


if __name__ == "__main__":
    main()
