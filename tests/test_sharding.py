"""Sharded-engine tests on the virtual 8-device CPU mesh: the peer axis is
sharded with jax.sharding; rolls/gathers in the gossip rounds must lower to
collectives and produce identical results to the unsharded path."""

import numpy as np
import pytest

import jax

from bullet_tpu.models.netsim import PeerNetworkSim
from bullet_tpu.parallel.mesh import make_mesh, peer_sharding, shard_table
from bullet_tpu.ops.merge import init_table
from bullet_tpu.parallel.gossip import gossip_round
from bullet_tpu.parallel import topology as topo

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@needs_devices
def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


@needs_devices
def test_sharded_gossip_matches_unsharded():
    rng = np.random.default_rng(0)
    t = init_table(16, 128)
    # random state
    import jax.numpy as jnp

    t = t._replace(
        cls=jnp.asarray(rng.integers(0, 4, size=(16, 128), dtype=np.int32)),
        khi=jnp.asarray(rng.integers(-50, 50, size=(16, 128), dtype=np.int32)),
        vid=jnp.asarray(rng.integers(0, 30, size=(16, 128), dtype=np.int32)),
    )
    ring = topo.ring(16)
    plain, c1 = gossip_round(t, ring, "reference")

    mesh = make_mesh()
    t_sharded = shard_table(t, mesh)
    sharded, c2 = gossip_round(t_sharded, ring, "reference")
    for a, b in zip(plain, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(c1) == int(c2)


@needs_devices
@pytest.mark.parametrize("topology", ["ring", "mesh", "bridge"])
def test_sharded_sim_converges(topology):
    sim = PeerNetworkSim(
        16, capacity=64, topology=topology if topology != "bridge" else topo.bridge((7, 7), 2),
        mesh_devices=8,
    )
    rng = np.random.default_rng(5)
    for _ in range(40):
        sim.put(int(rng.integers(16)), f"k/v{int(rng.integers(6))}", int(rng.integers(1000)))
    sim.run_until_converged()
    assert sim.tables_equal()
    # table is actually sharded over the mesh
    shardings = {d for f in sim.table for d in (len(f.devices()),)}
    assert max(shardings) == 8


@needs_devices
def test_sharded_equals_unsharded_final_state():
    def run(mesh_devices):
        sim = PeerNetworkSim(16, capacity=64, topology="ring", mesh_devices=mesh_devices)
        rng = np.random.default_rng(9)
        for _ in range(50):
            sim.put(int(rng.integers(16)), f"p/k{int(rng.integers(8))}", float(rng.integers(100)))
        sim.run_until_converged()
        return [np.asarray(f) for f in sim.table]

    a, b = run(None), run(8)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


@needs_devices
def test_sharded_reconcile_matches_unsharded():
    """reconcile() on a mesh-sharded sim (XLA doubling path: rolls lower
    to collective permutes) lands on the same fixed point as unsharded."""
    def run(mesh_devices, layout):
        sim = PeerNetworkSim(16, capacity=128, topology="ring",
                             mesh_devices=mesh_devices, layout=layout,
                             mode="reference")
        rng = np.random.default_rng(12)
        for _ in range(40):
            sim.put(int(rng.integers(16)), f"q/k{int(rng.integers(6))}",
                    float(rng.integers(1000)))
        sim.reconcile()
        assert sim.tables_equal()
        return [np.asarray(f) for f in sim.table]

    for layout in ("dense", "packed"):
        a = run(None, layout)
        b = run(8, layout)
        n_cmp = 4 if layout == "dense" else 3
        for fa, fb in zip(a[:n_cmp], b[:n_cmp]):
            np.testing.assert_array_equal(fa, fb, layout)


@needs_devices
@pytest.mark.parametrize("layout", ["dense", "packed", "rank1"])
def test_sim_table_is_built_on_the_mesh(layout):
    """The table is created shard by shard (never whole on one device),
    and its fields are distinct buffers the donating apply can consume."""
    sim = PeerNetworkSim(16, capacity=64, layout=layout, mesh_devices=8)
    want = peer_sharding(sim.mesh)
    for f in sim.table:
        assert f.sharding.is_equivalent_to(want, f.ndim)
        assert len(f.devices()) == 8
    sim.put(3, "k/a", 7)
    sim.step(0)
    sim.run_until_converged()
    assert sim.tables_equal()
    assert all(sim.get(p, "k/a") == 7 for p in (0, 8, 15))
    # a restored snapshot lands on the mesh too
    snap = sim.snapshot()
    sim.put(5, "k/a", 9)
    sim.run_until_converged()
    sim.restore(snap)
    for f in sim.table:
        assert f.sharding.is_equivalent_to(want, f.ndim)
    assert sim.get(15, "k/a") == 7
