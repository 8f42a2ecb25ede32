"""Serving-path benchmark: wire traffic → live mirror → view queries.

Measures the full production serving pipeline the live bridge enables
(docs/quick-start.md "stream LIVE"): a writer peer floods writes over a
real TCP socket to a serving peer whose accepted writes mirror into an
engine replica (`attach_live_bridge`), and request handlers serve
queries through the read-only `ReplicaView` facade while traffic flows.

Reported (one JSON dict):
- wire_writes_per_s  — socket → CRT → mirror enqueue, sustained
- mirror_lag_s       — time from last write landing in the db to the
                       view serving it (one apply of the queued backlog)
- idle query latency — p50/p95 over repeated equals/range/count with
                       refresh="apply" on a quiet mirror
- loaded query latency — the same while the writer floods concurrently
                       (each query folds the current backlog in first)

Run: python benchmarks/serving_bench.py [--writes 4000]
(CPU by default like the examples; BULLET_BACKEND=gpu for the GPU. The
output names the device it ran on.)
"""

import argparse
import json
import os
import sys
import threading
import time

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO)

if os.environ.get("BULLET_BACKEND", "cpu").lower() != "gpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import bullet_tpu as bt  # noqa: E402
from bullet_tpu.models.bridge import attach_live_bridge  # noqa: E402
from bullet_tpu.models.netsim import PeerNetworkSim  # noqa: E402


def wait_for(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def pctl(samples, q):
    return float(np.percentile(np.asarray(samples), q))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--writes", type=int, default=4000)
    args = ap.parse_args()

    sim = PeerNetworkSim(2, capacity=1 << 15, topology="ring", layout="rank1")
    serving = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                         "connect_sync_delay": 600})
    writer = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                        "peers": [f"tcp://127.0.0.1:{serving.network.port}"],
                        "connect_sync_delay": 600})
    handle = attach_live_bridge(serving, sim, peer=0)
    view = handle.view()
    # serving warmup: precompile the flat-apply bucket ladder so no live
    # query pays a first-of-its-batch-size XLA compile (reported, not free)
    t0 = time.time()
    sim.warm_apply_buckets(1 << 16)
    warm_s = round(time.time() - t0, 2)
    import jax

    dev0 = jax.devices()[0]
    out = {"platform": dev0.platform, "device_kind": dev0.device_kind,
           "warmup_s": warm_s}
    try:
        assert wait_for(lambda: serving.network.peers and writer.network.peers)

        # ---- wire throughput into the mirror ----
        n = args.writes
        t0 = time.time()
        for i in range(n):
            writer.get(f"cat/item{i:05d}").put(
                {"price": float(i % 1000), "tier": "gold" if i % 4 == 0
                 else "std"}
            )
        assert wait_for(
            lambda: len(serving.store.get("cat", {})) == n
        ), "flood did not finish"
        t1 = time.time()
        out["wire_writes_per_s"] = round(n / (t1 - t0))

        # ---- mirror lag: fold the whole backlog into the device ----
        t0 = time.time()
        assert view.count("cat", "tier", "gold") == (n + 3) // 4
        out["mirror_lag_s"] = round(time.time() - t0, 4)

        # ---- idle query latency through the facade ----
        lat = {"equals": [], "range": [], "count": []}
        for _ in range(60):
            t0 = time.perf_counter()
            view.equals("cat", "tier", "gold")
            lat["equals"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            view.range("cat", "price", 100.0, 200.0)
            lat["range"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            view.count("cat", "tier", "std")
            lat["count"].append(time.perf_counter() - t0)
        for k, v in lat.items():
            out[f"idle_{k}_p50_ms"] = round(pctl(v, 50) * 1e3, 2)
            out[f"idle_{k}_p95_ms"] = round(pctl(v, 95) * 1e3, 2)

        # ---- query latency under concurrent wire load ----
        stop = threading.Event()
        wrote = [0]

        def flood():
            i = 0
            while not stop.is_set():
                writer.get(f"cat/item{i % n:05d}/price").put(
                    float((i * 7) % 1000)
                )
                wrote[0] = i = i + 1

        th = threading.Thread(target=flood, daemon=True)
        th.start()
        loaded = []
        for _ in range(60):
            t0 = time.perf_counter()
            view.count("cat", "tier", "gold")
            loaded.append(time.perf_counter() - t0)
        stop.set()
        th.join(timeout=5)
        out["loaded_count_p50_ms"] = round(pctl(loaded, 50) * 1e3, 2)
        out["loaded_count_p95_ms"] = round(pctl(loaded, 95) * 1e3, 2)
        out["loaded_count_p99_ms"] = round(pctl(loaded, 99) * 1e3, 2)
        out["loaded_writer_rate_per_s"] = round(
            wrote[0] / max(sum(loaded), 1e-9)
        )
        # bounded-tail contract: queries must NOT convoy
        # behind the wire thread or fold an unbounded backlog — staging +
        # one put_bulk per query keeps refresh="apply" under 50 ms even
        # while the writer floods
        assert out["loaded_count_p95_ms"] < 50.0, (
            f"serving p95 {out['loaded_count_p95_ms']} ms under write flood "
            f"(bound: 50 ms)"
        )

        # correctness anchor under load: the view still serves exact counts
        assert view.count("cat", "tier", "gold") == (n + 3) // 4
        out["exact_after_load"] = True
    finally:
        handle.detach()
        serving.close()
        writer.close()

    print(json.dumps(out))


if __name__ == "__main__":
    main()
