"""Scale showcase: 1,024 simulated peers converging a large graph under
concurrent conflicting writes — the BASELINE.json north-star shape.

On CPU this runs a scaled-down config; on a GPU (BULLET_BACKEND=gpu) it
runs the full 1,024-peer network. The peer axis shards over however many
devices are available.
"""

import time

import numpy as np

import jax

import _env  # noqa: F401 - backend selection
from bullet_tpu.models.netsim import PeerNetworkSim


def main() -> None:
    full = jax.default_backend() == "gpu"
    num_peers = 1024 if full else 64
    keys = 4096 if full else 256
    writes = 16384 if full else 1024
    n_devices = len(jax.devices())
    mesh_devices = n_devices if n_devices > 1 else None

    print(f"{num_peers} peers (random gossip graph), {writes} concurrent writes "
          f"over {keys} keys, {n_devices} device(s)")

    from bullet_tpu.parallel import topology as topo

    t = topo.random_graph(num_peers, degree=4, seed=0)
    sim = PeerNetworkSim(
        num_peers, capacity=2 * keys, topology=t, mesh_devices=mesh_devices
    )

    rng = np.random.default_rng(0)
    t0 = time.time()
    peers = rng.integers(0, num_peers, size=writes)
    key_ids = rng.integers(0, keys, size=writes)
    values = rng.integers(0, 1_000_000, size=writes)
    for p, k, v in zip(peers, key_ids, values):
        sim.put(int(p), f"data/k{int(k)}", int(v))
    print(f"Enqueued {writes} writes in {time.time()-t0:.2f}s")

    t0 = time.time()
    rounds = sim.run_until_converged(max_rounds=64)
    dt = time.time() - t0
    print(f"Converged in {rounds} gossip rounds, {dt:.2f}s wall "
          f"({sim.stats['ops_applied']} ops applied)")
    assert sim.tables_equal()

    # spot-check: every peer agrees with the global comparator-max per key
    expected = {}
    for k, v in zip(key_ids, values):
        key = f"data/k{int(k)}"
        expected[key] = max(expected.get(key, -1), int(v))
    for probe in (0, num_peers // 2, num_peers - 1):
        for key in list(expected)[:16]:
            assert sim.get(probe, key) == expected[key]
    print("Spot checks passed: all replicas hold the global comparator-max")
    print("Scale example completed")


if __name__ == "__main__":
    main()
