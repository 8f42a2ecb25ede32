"""Phase-level profile of a fresh 1M-op apply at the north-star shape.

Breaks ``_apply_pending_packed`` into its host and device phases (drain →
rank stamp → native reduce → pad/stack → host-to-device copy → device
winners + scatter) so optimization work attacks the measured bottleneck.
Needs a GPU: it exits nonzero when JAX finds none.

Usage: python benchmarks/apply_profile.py [--layout packed|rank|rank1]
"""

import argparse
import json
import os
import sys
import time

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO_ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from bullet_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="packed",
                    choices=["packed", "rank", "rank1"])
    ap.add_argument("--writes", type=int, default=1 << 20)
    args = ap.parse_args()

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        sys.exit(f"apply_profile: needs a GPU, JAX found {dev0.platform}")
    enable_compile_cache()

    import jax.numpy as jnp

    from bullet_tpu.models.netsim import PeerNetworkSim, _pad_flat_ops
    from bullet_tpu.parallel import topology as topo

    num_peers, capacity, keys, writes = 1024, 1 << 20, 1 << 16, args.writes
    sim = PeerNetworkSim(num_peers, capacity=capacity,
                         topology=topo.ring(num_peers), layout=args.layout)
    slots = sim.host.intern_batch([f"g/k{i}" for i in range(keys)])
    rng = np.random.default_rng(0)

    def load():
        sim.put_bulk(
            rng.integers(0, num_peers, writes).astype(np.int32),
            slots[rng.integers(0, keys, writes)],
            rng.integers(0, 1 << 30, writes).astype(np.float64),
        )

    out = {"platform": dev0.platform, "device_kind": dev0.device_kind,
           "device_count": len(jax.devices()), "layout": args.layout,
           "writes": writes, "peers": num_peers, "capacity": capacity}

    # compile every apply program on a first load (set-up)
    load()
    t0 = time.perf_counter()
    sim.step(rounds=0)
    jax.block_until_ready(sim.table)
    out["warm_apply_s"] = time.perf_counter() - t0

    # instrumented second load
    t0 = time.perf_counter()
    load()
    out["ingest_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    peer, slot, cls, khi, klo, vid = sim._drain_flat()
    out["drain_s"] = time.perf_counter() - t0

    if args.layout in ("rank", "rank1"):
        from bullet_tpu.ops.packed import CV_SHIFT
        from bullet_tpu.ops.rank import reduce_flat_ops_rank

        t0 = time.perf_counter()
        sim._sync_rank_index()
        rmap = sim.rank_index.rank_map()
        rank_f = rmap[vid]
        cv_f = ((cls.astype(np.int64) << CV_SHIFT) | vid).astype(np.int32)
        out["rank_stamp_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reduced = reduce_flat_ops_rank(peer, slot, rank_f, cv_f)
        out["reduce_s"] = time.perf_counter() - t0
        if args.layout == "rank1":
            reduced = reduced[:3]
    else:
        from bullet_tpu.ops.packed import reduce_flat_ops

        t0 = time.perf_counter()
        reduced = reduce_flat_ops(peer, slot, cls, khi, klo, vid)
        out["reduce_s"] = time.perf_counter() - t0
    out["reduced_k"] = int(len(reduced[0]))

    p_, n_ = sim.table[0].shape
    t0 = time.perf_counter()
    stacked = np.stack(_pad_flat_ops(reduced, p_, n_))
    out["stack_s"] = time.perf_counter() - t0
    out["h2d_bytes"] = int(stacked.nbytes)

    t0 = time.perf_counter()
    dev = jnp.asarray(stacked)
    dev.block_until_ready()
    out["h2d_s"] = time.perf_counter() - t0

    if args.layout == "rank1":
        from bullet_tpu.ops.rank import apply_flat_rank1_stacked as apply_fn
    elif args.layout == "rank":
        from bullet_tpu.ops.rank import apply_flat_rank_stacked as apply_fn
    else:
        from bullet_tpu.ops.packed import apply_flat_packed_stacked as apply_fn

    t0 = time.perf_counter()
    sim.table, applied = apply_fn(sim.table, dev)
    jax.block_until_ready((sim.table, applied))
    out["device_apply_s"] = time.perf_counter() - t0
    out["applied"] = int(applied)

    phases = ("drain_s", "rank_stamp_s", "reduce_s", "stack_s", "h2d_s",
              "device_apply_s")
    out["apply_total_s"] = sum(out.get(k, 0.0) for k in phases)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
