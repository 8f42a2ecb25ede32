"""Incremental convergence: small update batches on a converged graph.

This demo builds a converged 64-peer graph, then pushes small update
batches and shows each incremental convergence — with results identical to
a from-scratch run, and to a direct ``reconcile()``.
"""

import _env  # noqa: F401  (backend selection)

import time

import numpy as np

from bullet_tpu.models.netsim import PeerNetworkSim


def main() -> None:
    peers, capacity = 64, 1 << 13
    sim = PeerNetworkSim(peers, capacity=capacity, topology="ring",
                         layout="packed")

    # bulk-load a base graph and converge it fully once
    rng = np.random.default_rng(0)
    k = 20_000
    sim.put_bulk(
        rng.integers(0, peers, k).astype(np.int32),
        [f"sensors/s{i % 2000}/reading" for i in range(k)],
        rng.uniform(0, 100, k),
    )
    t0 = time.time()
    rounds = sim.run_until_converged()
    print(f"base load: {k} writes converged in {rounds} rounds "
          f"({time.time()-t0:.2f}s)")
    assert sim.tables_equal()

    # incremental batches
    all_ops = []
    for batch in range(3):
        ops = [(int(rng.integers(peers)), f"sensors/s{int(rng.integers(50))}/reading",
                float(200 + batch)) for _ in range(25)]
        all_ops += ops
        for peer, path, value in ops:
            sim.put(peer, path, value)
        t0 = time.time()
        rounds = sim.run_until_converged()
        assert sim.tables_equal()
        print(f"incremental batch {batch}: 25 writes, {rounds} rounds "
              f"({time.time()-t0:.2f}s)")

    # equivalence: a from-scratch sim fed everything lands on the same state
    fresh = PeerNetworkSim(peers, capacity=capacity, topology="ring",
                           layout="packed")
    rng2 = np.random.default_rng(0)
    fresh.put_bulk(
        rng2.integers(0, peers, k).astype(np.int32),
        [f"sensors/s{i % 2000}/reading" for i in range(k)],
        rng2.uniform(0, 100, k),
    )
    for peer, path, value in all_ops:
        fresh.put(peer, path, value)
    fresh.run_until_converged()
    for f_inc, f_fresh in zip(sim.table, fresh.table):
        np.testing.assert_array_equal(np.asarray(f_inc), np.asarray(f_fresh))
    print("incremental state bit-matches the from-scratch run")

    # direct reconciliation: when only the reconciled state matters (not
    # the round-by-round protocol), reconcile() jumps straight to the
    # fixed point in ceil(log2 P) doubling merges — same state, no
    # simulated rounds
    direct = PeerNetworkSim(peers, capacity=capacity, topology="ring",
                            layout="packed")
    rng3 = np.random.default_rng(0)
    direct.put_bulk(
        rng3.integers(0, peers, k).astype(np.int32),
        [f"sensors/s{i % 2000}/reading" for i in range(k)],
        rng3.uniform(0, 100, k),
    )
    for peer, path, value in all_ops:
        direct.put(peer, path, value)
    t0 = time.time()
    direct.reconcile()
    assert direct.tables_equal()
    for f_d, f_fresh in zip(direct.table, fresh.table):
        np.testing.assert_array_equal(np.asarray(f_d), np.asarray(f_fresh))
    print(f"reconcile() reached the same fixed point directly "
          f"({time.time()-t0:.2f}s, no simulated rounds)")
    print("Incremental example completed")


if __name__ == "__main__":
    main()
