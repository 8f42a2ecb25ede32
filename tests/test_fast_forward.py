"""sim.fast_forward(k): bit-identical to step(k) — same tables, same
returned last-round residual — computed as O(log k) window joins instead
of k sequential gossip rounds (ops/packed.ring_window_packed_xla, and its
shard_map twin on a mesh). Ineligible configurations (dense layouts,
generic topologies) must silently delegate to step(k) with identical
semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from bullet_tpu.models.netsim import PeerNetworkSim

VALS = ["alice", "bob", 3.5, -7, 0, True, False, None, "zed", 1e300, -0.5]


def _seed(sim, rng, n_writes=120):
    for _ in range(n_writes):
        peer = int(rng.integers(0, sim.num_peers))
        path = f"users/u{int(rng.integers(0, 15))}/f{int(rng.integers(0, 3))}"
        sim.put(peer, path, VALS[int(rng.integers(0, len(VALS)))])


def _pair(layout, topology, n=8, seed=0, **kw):
    a = PeerNetworkSim(n, capacity=128, topology=topology, layout=layout, **kw)
    b = PeerNetworkSim(n, capacity=128, topology=topology, layout=layout, **kw)
    _seed(a, np.random.default_rng(seed))
    _seed(b, np.random.default_rng(seed))
    return a, b


def _tables_equal(a, b):
    for x, y in zip(a.table, b.table):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_fast_forward_matches_step(layout, topology):
    for k in (1, 3, 7):
        a, b = _pair(layout, topology, seed=10 + k)
        ra = a.step(k)
        rb = b.fast_forward(k)
        assert ra == rb, (layout, topology, k)
        _tables_equal(a, b)
        assert a.stats["gossip_rounds"] == b.stats["gossip_rounds"]
        assert b.stats["windowed_rounds"] == k
        # reads agree after the jump
        for peer in (0, a.num_peers - 1):
            assert a.get(peer, "users/u3/f1") == b.get(peer, "users/u3/f1")


@pytest.mark.parametrize("layout", ["packed", "rank1"])
def test_fast_forward_to_convergence(layout):
    """A diameter-deep jump lands on the run_until_converged fixed point
    with residual 0 (the window's count is the classic last-round
    residual, so a converged jump reports exactly 0)."""
    a, b = _pair(layout, "ring", seed=3)
    a.run_until_converged()
    rb = b.fast_forward(2 * b.topology.diameter + 2)
    assert rb == 0
    _tables_equal(a, b)


def test_fast_forward_fallbacks_delegate_to_step():
    """Dense layouts and generic topologies take the step() path and stay
    exact (windowed_rounds stays 0 — nothing was window-fused)."""
    a, b = _pair("dense", "ring", seed=5)
    ra, rb = a.step(4), b.fast_forward(4)
    assert ra == rb
    for x, y in zip(a.table, b.table):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert b.stats["windowed_rounds"] == 0

    a, b = _pair("packed", "mesh", seed=6)
    ra, rb = a.step(2), b.fast_forward(2)
    assert ra == rb
    _tables_equal(a, b)
    assert b.stats["windowed_rounds"] == 0


def test_fast_forward_applies_pending_ops():
    """Queued puts land before the jump, exactly like step()."""
    a, b = _pair("rank1", "chain", seed=7)
    a.step(2)
    b.fast_forward(2)
    a.put(0, "late/x", 99)
    b.put(0, "late/x", 99)
    ra, rb = a.step(5), b.fast_forward(5)
    assert ra == rb
    _tables_equal(a, b)
    assert a.get(5, "late/x") == b.get(5, "late/x") == 99


@pytest.mark.parametrize("layout", ["packed", "rank1"])
@pytest.mark.parametrize("topology", ["ring", "chain"])
def test_fast_forward_spmd_matches_step(layout, topology):
    """Under a shard_map mesh, fast_forward rides the explicit-SPMD window
    (one m-row boundary collective per m rounds, passes capped at the
    per-device row count — 2 here, so a 7-round jump spans 4 passes) and
    stays bit-identical to step()."""
    kw = dict(mesh_devices=8, use_shard_map=True)
    for k in (1, 3, 7):
        a, b = _pair(layout, topology, n=16, seed=20 + k, **kw)
        ra = a.step(k)
        rb = b.fast_forward(k)
        assert ra == rb, (layout, topology, k)
        _tables_equal(a, b)
        assert b.stats["windowed_rounds"] == k
        for peer in (0, 15):
            assert a.get(peer, "users/u3/f1") == b.get(peer, "users/u3/f1")


def test_fast_forward_data_mesh_matches_step():
    """Data-mesh sharding (no shard_map): the XLA window twin runs with
    XLA-inferred collectives; still bit-identical to step()."""
    a, b = _pair("rank1", "ring", n=16, seed=31, mesh_devices=8)
    ra, rb = a.step(5), b.fast_forward(5)
    assert ra == rb
    _tables_equal(a, b)
    assert b.stats["windowed_rounds"] == 5


def test_fast_forward_route_matrix():
    """Pin the route decision per configuration."""
    r1 = PeerNetworkSim(8, capacity=256, topology="ring", layout="rank1")
    assert r1._fast_forward_route() == "xla"

    pk3 = PeerNetworkSim(8, capacity=256, topology="chain", layout="packed")
    assert pk3._fast_forward_route() == "xla"

    dense = PeerNetworkSim(8, capacity=256, topology="ring")
    assert dense._fast_forward_route() == "step"

    mesh_topo = PeerNetworkSim(8, capacity=256, topology="mesh",
                               layout="rank1")
    assert mesh_topo._fast_forward_route() == "step"

    dm = PeerNetworkSim(16, capacity=256, topology="ring", layout="rank1",
                        mesh_devices=8)
    assert dm._fast_forward_route() == "xla"  # rolls lower to collectives

    spmd = PeerNetworkSim(16, capacity=256, topology="ring", layout="rank1",
                          mesh_devices=8, use_shard_map=True)
    assert spmd._fast_forward_route() == "spmd"


@pytest.mark.parametrize("k", [2, 5, 40])
@pytest.mark.parametrize("layout", ["packed", "rank", "rank1"])
def test_fast_forward_cutoff_matches_step(layout, k):
    """Jumps that stop short of the fixed point (k=2, 5) and that run
    past it (k=40, which the window ends early at its first identity
    pass) both match step(k): tables, residual and accounting."""
    a, b = _pair(layout, "ring", seed=50 + k)
    ra = a.step(k)
    rb = b.fast_forward(k)
    assert ra == rb, (k, ra, rb)
    _tables_equal(a, b)
    assert b.stats["windowed_rounds"] == k
    assert b.stats["gossip_rounds"] == a.stats["gossip_rounds"] == k
