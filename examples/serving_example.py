"""Engine-backed serving: a wire-connected peer as a live engine replica.

A writer peer and a serving peer talk the REAL wire protocol (the same
one bullet-js speaks — TCP/NDJSON here; ws:// works identically). The
serving peer runs `attach_live_bridge`, so every write it accepts — its
own or flooded/synced from the writer — streams into a PeerNetworkSim
replica on the accelerator. Reads and vectorized queries (equals/range/
count) are then served from device state at engine speed, at any scale
the compact layouts reach (1,024 peers × 1M slots on one chip).

Self-verifying; run `python examples/serving_example.py`.
"""

import _env  # noqa: F401  (repo path + CPU backend)

import time

import bullet_tpu as bt
from bullet_tpu.models.bridge import attach_live_bridge
from bullet_tpu.models.netsim import PeerNetworkSim


def wait_for(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def main() -> None:
    # the engine replica: rank1 layout = 4 B/entry device state
    sim = PeerNetworkSim(2, capacity=1024, topology="ring", layout="rank1")

    serving = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                         "connect_sync_delay": 600})
    writer = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                        "peers": [f"tcp://127.0.0.1:{serving.network.port}"],
                        "connect_sync_delay": 600})
    handle = attach_live_bridge(serving, sim, peer=0)
    try:
        assert wait_for(lambda: serving.network.peers and writer.network.peers)

        # the writer publishes a catalog over the wire
        for i in range(40):
            writer.get(f"catalog/item{i:02d}").put(
                {"price": float(10 + i), "tier": "gold" if i % 4 == 0
                 else "std"}
            )
        assert wait_for(
            lambda: len(serving.store.get("catalog", {})) == 40
        ), "flood did not finish"

        # serve through the read-only facade: the default apply-only
        # refresh folds queued mirror writes in per query — request
        # handlers get queries without write access or explicit flushes
        view = handle.view()
        gold = view.equals("catalog", "tier", "gold")
        assert len(gold) == 10, gold
        mid = view.range("catalog", "price", 20.0, 29.0)
        assert len(mid) == 10, mid
        assert view.count("catalog", "tier", "std") == 30
        assert view.get("catalog/item07/price") == 17.0

        # full convergence only matters for multi-peer engine state
        handle.flush()
        assert sim.tables_equal()

        # live update: the writer reprices one item; the view follows
        # without a flush
        writer.get("catalog/item00/price").put(99.0)
        assert wait_for(
            lambda: serving.store["catalog"]["item00"]["price"] == 99.0
        )
        assert view.get("catalog/item00/price") == 99.0
        assert view.range("catalog", "price", 90.0, 100.0) == [
            "catalog/item00"
        ]

        print("serving example OK: 40-item catalog flooded over the wire,")
        print("mirrored into the rank1 engine replica, queries + live "
              "repricing verified")
    finally:
        handle.detach()
        serving.close()
        writer.close()


if __name__ == "__main__":
    main()
