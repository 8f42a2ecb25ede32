"""Secondary BASELINE metric: gossip rounds to convergence on a 1k-peer
network, across topologies.

Prints one JSON line per topology:
    {"topology", "num_peers", "diameter", "rounds", "wall_s", "platform"}

Run on CPU (default) or set BULLET_BACKEND=gpu.
"""

import json
import os
import sys
import time

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_REPO_ROOT, "examples"))
sys.path.insert(0, _REPO_ROOT)
import _env  # noqa: F401,E402 - backend selection

import jax  # noqa: E402
import numpy as np  # noqa: E402

from bullet_tpu.models.netsim import PeerNetworkSim  # noqa: E402
from bullet_tpu.parallel import topology as topo  # noqa: E402


def run(name, topology, num_peers=1024, keys=1024, writes=4096):
    sim = PeerNetworkSim(num_peers, capacity=2 * keys, topology=topology)
    slots = np.asarray(
        [sim.intern_path(f"data/k{i}") for i in range(keys)], dtype=np.int32
    )
    rng = np.random.default_rng(0)
    sim.put_bulk(
        rng.integers(0, num_peers, writes).astype(np.int32),
        slots[rng.integers(0, keys, writes)],
        rng.integers(0, 1 << 20, writes).astype(np.float64),
    )
    t0 = time.time()
    rounds = sim.run_until_converged(max_rounds=2 * num_peers)
    wall = time.time() - t0
    assert sim.tables_equal()
    print(
        json.dumps(
            {
                "topology": name,
                "num_peers": num_peers,
                "diameter": sim.topology.diameter,
                "rounds": rounds,
                "wall_s": round(wall, 3),
                "platform": jax.devices()[0].platform,
            }
        ),
        flush=True,
    )


def main() -> None:
    small = "--small" in sys.argv
    peers = 128 if small else 1024
    run("mesh", topo.full_mesh(peers), peers)
    run("random4", topo.random_graph(peers, 4, seed=0), peers)
    run("ring", topo.ring(peers), peers)
    run("star", topo.star(peers), peers)
    run("bridge", topo.bridge((peers // 2, peers // 2 - 1), 1), peers)


if __name__ == "__main__":
    main()
