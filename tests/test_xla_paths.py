"""The XLA convergence loop and window join against the classic step loop.

Every layout (dense in both modes and lean, packed, rank, rank1) on ring
and chain: ``run_until_converged`` must land on the state, round count and
last-round residual of stepping one round at a time, also when
``max_rounds`` cuts it off; ``ring_window_packed_xla`` must equal m
sequential rounds, with the classic round-m residual.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bullet_tpu.models.netsim import PeerNetworkSim
from bullet_tpu.ops.packed import (
    VID_MASK,
    PackedTable,
    gossip_round_chain_packed,
    gossip_round_ring_packed,
    ring_window_packed_xla,
)
from bullet_tpu.ops.rank import Rank1Table, RankTable

SIM_CASES = {
    "dense-reference": dict(layout="dense", mode="reference"),
    "dense-lww": dict(layout="dense", mode="lww"),
    "dense-lean": dict(layout="dense", mode="reference", lean_gossip=True),
    "packed": dict(layout="packed"),
    "rank": dict(layout="rank"),
    "rank1": dict(layout="rank1"),
}


def _loaded_sim(kw, topology, seed=5):
    sim = PeerNetworkSim(16, capacity=256, topology=topology, **kw)
    rng = np.random.default_rng(seed)
    for _ in range(80):
        sim.put(int(rng.integers(16)), f"g/k{int(rng.integers(24))}",
                float(rng.integers(1000)))
    sim.put(3, "g/name", "zeta")
    sim.put(11, "g/name", "alpha")
    return sim


@pytest.mark.parametrize("max_rounds", [None, 3])
@pytest.mark.parametrize("topology", ["ring", "chain"])
@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_converge_matches_step_loop(case, topology, max_rounds):
    loop = _loaded_sim(SIM_CASES[case], topology)
    classic = _loaded_sim(SIM_CASES[case], topology)
    rounds = loop.run_until_converged(max_rounds)

    cap = max_rounds if max_rounds is not None else 4 * 16
    want_rounds, residual = 0, None
    while want_rounds < cap:
        residual = classic.step(1)
        want_rounds += 1
        if residual == 0:
            break
    assert rounds == want_rounds
    assert loop.last_residual == residual
    if max_rounds is None:
        assert residual == 0 and loop.tables_equal()
    else:
        assert residual > 0  # the cap cut a live convergence
    for a, b in zip(loop.table, classic.table):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _random_table(layout, p, n, seed):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return rng.integers(lo, hi, (p, n)).astype(np.int32)

    if layout == "packed":
        cls = arr(0, 4)
        present = cls > 0
        cv = np.where(present, (cls << 28) | arr(0, 30), 0)
        return PackedTable(
            khi=jnp.asarray(np.where(present, arr(-50, 50), 0)),
            klo=jnp.asarray(np.where(present, arr(-50, 50), 0)),
            cv=jnp.asarray(cv),
        )
    # rank 0 = absent; equal ranks are the same entry, so the rank
    # layout's cv payload is a function of the rank
    rank = np.where(arr(0, 4) > 0, arr(1, 1 << 20), 0)
    if layout == "rank1":
        return Rank1Table(rank=jnp.asarray(rank))
    cv = np.where(rank > 0, (1 << 28) | (rank & VID_MASK), 0)
    return RankTable(rank=jnp.asarray(rank), cv=jnp.asarray(cv))


@pytest.mark.parametrize("m", [1, 2, 3, 5, 13, 40, 70])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
def test_window_matches_step_loop(layout, wrap, m):
    """m=70 > P=64 pins the saturated window (the ring window wraps onto
    itself; chain windows clip at the edges)."""
    t0 = _random_table(layout, 64, 256, seed=7)
    round_fn = gossip_round_ring_packed if wrap else gossip_round_chain_packed
    a = type(t0)(*(jnp.array(f) for f in t0))
    last = 0
    for _ in range(m):
        a, c = round_fn(a)
        last = int(c)
    b, cb = ring_window_packed_xla(type(t0)(*(jnp.array(f) for f in t0)),
                                   wrap, m)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert last == int(cb)
