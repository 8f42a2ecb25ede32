"""14-peer ring network to convergence — on the engine.

Mirrors /root/reference/examples/bullet-circle-network-example.js (14 nodes,
2 neighbors each, periodic updates, convergence monitoring) with the
one-OS-process-per-peer deployment replaced by the simulation engine: every
peer is a row of the device table and a gossip round is one compiled
program.
"""

import _env  # noqa: F401 - backend selection
import random

from bullet_tpu.models.netsim import PeerNetworkSim

NUM_PEERS = 14
UPDATE_STEPS = 5


def main() -> None:
    sim = PeerNetworkSim(NUM_PEERS, capacity=256, topology="ring")
    rng = random.Random(7)
    print(f"Ring of {NUM_PEERS} peers, diameter {sim.topology.diameter}")

    for step in range(UPDATE_STEPS):
        # each step, a few random peers publish fresh data (the reference's
        # 5-second update timers)
        for _ in range(4):
            peer = rng.randrange(NUM_PEERS)
            sim.put(
                peer,
                f"nodes/node{peer}/status",
                {"updatedAt": step, "value": rng.randint(0, 999)},
            )
        rounds = sim.run_until_converged()
        assert sim.tables_equal()
        print(f"step {step}: converged in {rounds} gossip rounds; "
              f"all {NUM_PEERS} replicas identical")

    # every peer sees every node's data (the reference's /status aggregation)
    for peer in (0, 7, 13):
        nodes = sim.get(peer, "nodes") or {}
        print(f"peer {peer} sees {len(nodes)} node records")
    visible = {len(sim.get(p, "nodes") or {}) for p in range(NUM_PEERS)}
    assert len(visible) == 1

    print("Engine stats:", sim.stats)
    print("Circle network example completed")


if __name__ == "__main__":
    main()
