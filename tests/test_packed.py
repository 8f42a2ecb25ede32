"""Packed 12 B/entry layout (ops/packed.py): bit-identity with dense
reference mode, the XLA window join and reconcile against the classic
round loop, and sim integration."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bullet_tpu.models.netsim import PeerNetworkSim
from bullet_tpu.ops.merge import TableState, merge_tables_xla
from bullet_tpu.ops.packed import (
    CV_SHIFT,
    VID_MASK,
    PackedTable,
    apply_ops_packed,
    gossip_round_chain_packed,
    gossip_round_generic_packed,
    gossip_round_mesh_packed,
    gossip_round_ring_packed,
    merge_packed_xla,
    pack_table,
    unpack_table,
)
from bullet_tpu.parallel import topology as topo
from bullet_tpu.parallel.gossip import (
    gossip_round_chain,
    gossip_round_generic,
    gossip_round_mesh,
    gossip_round_ring,
)


def random_dense(p, n, seed=0):
    """Sim-realistic dense table: absent entries all-zero, metadata zeroed
    (packed mode drops it, so value-state comparisons need it zero)."""
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return jnp.asarray(rng.integers(lo, hi, (p, n), dtype=np.int32))

    cls = arr(0, 4)
    present = cls > 0
    z = jnp.zeros((p, n), dtype=jnp.int32)
    m = lambda a: jnp.where(present, a, z)
    return TableState(cls, m(arr(-50, 50)), m(arr(-50, 50)), m(arr(0, 30)), z, z, z)


def value_state(t: TableState):
    return [np.asarray(f) for f in (t.cls, t.khi, t.klo, t.vid)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_packed_matches_dense(seed):
    a, b = random_dense(16, 256, seed), random_dense(16, 256, seed + 100)
    dm, dc = merge_tables_xla(a, b, "reference")
    pm, pc = merge_packed_xla(pack_table(a), pack_table(b))
    for x, y in zip(value_state(dm), value_state(unpack_table(pm))):
        np.testing.assert_array_equal(x, y)
    assert int(dc) == int(pc)


@pytest.mark.parametrize("maker_pair", [
    (gossip_round_ring, gossip_round_ring_packed),
    (gossip_round_chain, gossip_round_chain_packed),
    (gossip_round_mesh, gossip_round_mesh_packed),
])
def test_rounds_match_dense(maker_pair):
    dense_fn, packed_fn = maker_pair
    t = random_dense(16, 256, seed=3)
    dm, dc = dense_fn(t, "reference")
    pm, pc = packed_fn(pack_table(t))
    for x, y in zip(value_state(dm), value_state(unpack_table(pm))):
        np.testing.assert_array_equal(x, y)
    assert int(dc) == int(pc)


def test_generic_round_matches_dense():
    t = random_dense(11, 256, seed=4)
    nb = jnp.asarray(topo.bridge((5, 5), 1).neighbors)
    dm, dc = gossip_round_generic(t, nb, "reference")
    pm, pc = gossip_round_generic_packed(pack_table(t), nb)
    for x, y in zip(value_state(dm), value_state(unpack_table(pm))):
        np.testing.assert_array_equal(x, y)
    assert int(dc) == int(pc)


def test_apply_matches_dense_values():
    """Value state after packed apply == dense apply (metadata aside).
    Note packed 'applied' may be lower: dense counts metadata-only wins."""
    from bullet_tpu.ops.apply import OpBatch, apply_ops
    from bullet_tpu.ops.merge import init_table
    from bullet_tpu.ops.packed import init_packed

    rng = np.random.default_rng(6)
    p, n, b = 8, 64, 5
    ops = OpBatch(
        slot=jnp.asarray(rng.integers(0, n, (p, b), dtype=np.int32)),
        cls=jnp.asarray(rng.integers(0, 4, (p, b), dtype=np.int32)),
        khi=jnp.asarray(rng.integers(-50, 50, (p, b), dtype=np.int32)),
        klo=jnp.asarray(rng.integers(-50, 50, (p, b), dtype=np.int32)),
        vid=jnp.asarray(rng.integers(0, 30, (p, b), dtype=np.int32)),
        ctr=jnp.asarray(rng.integers(1, 9, (p, b), dtype=np.int32)),
    )
    dense, _ = apply_ops(init_table(p, n), ops, jnp.int32(1), mode="reference")
    packed, _ = apply_ops_packed(init_packed(p, n), ops, jnp.int32(1))
    for x, y in zip(value_state(dense), value_state(unpack_table(packed))):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- sim e2e


@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star", "bridge"])
def test_sim_packed_matches_dense(topology):
    def run(layout):
        sim = PeerNetworkSim(11, capacity=64, topology=topology, layout=layout)
        rng = np.random.default_rng(8)
        for _ in range(60):
            sim.put(int(rng.integers(11)), f"g/k{int(rng.integers(8))}",
                    float(rng.integers(100)))
        sim.put(0, "g/name", "zeta")
        sim.put(5, "g/name", "alpha")
        sim.run_until_converged()
        assert sim.tables_equal()
        return sim.get(3, "g")

    assert run("packed") == run("dense")


def test_sim_packed_strings_rekey_and_queries():
    """String interning triggers rank rebalances; packed re-keying must track
    them, and queries must work off the packed rows."""
    sim = PeerNetworkSim(4, capacity=64, topology="ring", layout="packed")
    names = [f"u{i:02d}" for i in range(20)]
    for i, nm in enumerate(names):
        sim.put(i % 4, f"users/m{i}/name", nm)
        sim.put(i % 4, f"users/m{i}/age", float(20 + i))
    sim.run_until_converged()
    assert sim.tables_equal()
    assert sim.equals(0, "users", "name", "u07") == ["users/m7"]
    assert sim.range(2, "users", "age", 25, 27) == [
        "users/m5", "users/m6", "users/m7"
    ]
    assert sim.count(1, "users", "name", "u03") == 1


def test_sim_packed_capacity_growth():
    sim = PeerNetworkSim(4, capacity=8, topology="ring", layout="packed")
    for i in range(40):
        sim.put(i % 4, f"deep/k{i}", i)
    sim.run_until_converged()
    assert sim.capacity >= 40
    assert sim.get(3, "deep/k39") == 39


def test_sim_packed_checkpoint_roundtrip(tmp_path):
    sim = PeerNetworkSim(4, capacity=64, topology="ring", layout="packed")
    sim.put(0, "a/b", 5)
    sim.put(2, "a/s", "str")
    sim.run_until_converged()
    sim.save_checkpoint(str(tmp_path / "ck"))
    loaded = PeerNetworkSim.load_checkpoint(str(tmp_path / "ck"))
    assert loaded.layout == "packed"
    assert loaded.get(1, "a") == sim.get(1, "a")
    loaded.put(3, "a/b", 50)
    loaded.run_until_converged()
    assert loaded.get(0, "a/b") == 50


def test_sim_packed_validation_ingress():
    """Device validation veto composes with the packed layout (masks run on
    the OpBatch before packing)."""
    sim = PeerNetworkSim(4, capacity=64, topology="ring", layout="packed")
    sim.define_schema("m", {"properties": {"v": {"type": "number", "min": 0}}})
    sim.apply_schema("items", "m")
    sim.put_bulk(np.array([0, 1], dtype=np.int32),
                 ["items/a/v", "items/b/v"], np.array([5.0, -5.0]))
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(2, "items/a/v") == 5.0
    assert sim.get(2, "items/b/v") is None


def test_packed_rejects_lww():
    with pytest.raises(ValueError):
        PeerNetworkSim(4, layout="packed", mode="lww")


def test_packed_sharded_matches_unsharded():
    """Packed layout over the virtual 8-device mesh: jit-inferred and
    explicit shard_map paths both converge to the unsharded fixed point."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")

    def run(**kw):
        sim = PeerNetworkSim(16, capacity=64, topology="ring",
                             layout="packed", **kw)
        rng = np.random.default_rng(21)
        for _ in range(50):
            sim.put(int(rng.integers(16)), f"k/v{int(rng.integers(6))}",
                    int(rng.integers(1000)))
        sim.run_until_converged()
        assert sim.tables_equal()
        return [np.asarray(f) for f in sim.table]

    plain = run()
    inferred = run(mesh_devices=8)
    spmd = run(mesh_devices=8, use_shard_map=True)
    for a, b, c in zip(plain, inferred, spmd):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_packed_shardmap_round_bitidentical():
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from bullet_tpu.parallel.mesh import make_mesh, shard_table
    from bullet_tpu.parallel.shardmap_gossip import ring_round_shardmap_packed

    t = pack_table(random_dense(16, 128, seed=9))
    mesh = make_mesh()
    for wrap, ref_fn in ((True, gossip_round_ring_packed),
                         (False, gossip_round_chain_packed)):
        expected, c_ref = ref_fn(t)
        got, c_got = ring_round_shardmap_packed(
            shard_table(t, mesh), mesh, wrap=wrap)
        for a, b in zip(expected, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(c_ref) == int(c_got)


def test_flat_scatter_blocked_path_no_cross_block_corruption():
    """One op per peer, each to its own slot: the flat apply must land
    every op in its own row and touch no other row."""
    from bullet_tpu.ops.packed import apply_flat_packed, init_packed

    p, n = 32, 1 << 12
    tbl = init_packed(p, n)
    # one op per peer, each to a distinct slot, value = peer+1
    peer = jnp.arange(p, dtype=jnp.int32)
    slot = jnp.arange(p, dtype=jnp.int32) * 7
    khi = peer + 1
    klo = jnp.zeros(p, dtype=jnp.int32)
    cv = (jnp.full(p, 2, dtype=jnp.int32) << 28) | (peer + 2)
    out, applied = apply_flat_packed(tbl, peer, slot, khi, klo, cv)
    assert int(applied) == p
    got_khi = np.asarray(out.khi)
    got_cv = np.asarray(out.cv)
    for q in range(p):
        row_hits = np.nonzero(got_cv[q])[0]
        assert row_hits.tolist() == [q * 7], (q, row_hits)  # no foreign rows
        assert got_khi[q, q * 7] == q + 1


def test_frontier_incremental_seed():
    """A second convergence after a completed one, with only a few new
    ops, reaches the exact state a from-scratch sim produces."""
    def final_state(ops):
        sim = PeerNetworkSim(16, capacity=2048, topology="ring",
                             layout="packed")
        for peer, path, value in ops:
            sim.put(peer, path, value)
        sim.run_until_converged()
        assert sim.tables_equal()
        return [np.asarray(f) for f in sim.table]

    first = [(i % 16, f"a/k{i % 40}", i) for i in range(100)]
    second = [(3, "a/k7", 10_000), (9, "b/new", 42)]

    sim = PeerNetworkSim(16, capacity=2048, topology="ring",
                         layout="packed")
    for peer, path, value in first:
        sim.put(peer, path, value)
    sim.run_until_converged()
    assert sim.converged()
    for peer, path, value in second:
        sim.put(peer, path, value)
    sim.run_until_converged()
    assert sim.tables_equal()
    want = final_state(first + second)
    for a, b in zip(want, sim.table):
        np.testing.assert_array_equal(a, np.asarray(b))
    # reads still correct
    assert sim.get(0, "a/k7") == 10_000
    assert sim.get(15, "b/new") == 42


def test_frontier_seed_invalidation_paths():
    """Manual step rounds between convergences, and a snapshot/restore,
    leave run_until_converged on the same fixed point."""
    sim = PeerNetworkSim(16, capacity=256, topology="ring", layout="packed")
    sim.put(0, "x/a", 1)
    sim.run_until_converged()
    assert sim.converged()
    sim.put(1, "x/a", 2)
    sim.step()  # one manual gossip round
    assert not sim.converged()
    sim.run_until_converged()
    assert sim.tables_equal()
    snap = sim.snapshot()
    sim.restore(snap)
    sim.run_until_converged()
    assert sim.tables_equal() and sim.get(5, "x/a") == 2


@pytest.mark.parametrize("wrap", [True, False])
def test_window_xla_matches_sequential(wrap):
    """The whole-table XLA window (fast_forward's single-device path, any
    shape — including non-stripe-tileable ones) must match m sequential
    XLA rounds in state AND round-m residual."""
    from bullet_tpu.ops.packed import (
        gossip_round_chain_packed,
        gossip_round_ring_packed,
        ring_window_packed_xla,
    )

    round_fn = gossip_round_ring_packed if wrap else gossip_round_chain_packed
    for m in (1, 2, 5, 13, 40):
        # P=12 is NOT 8-aligned: the XLA twin has no tiling constraint
        t0 = pack_table(random_dense(12, 96, seed=9))
        a = PackedTable(*(jnp.array(f) for f in t0))
        last = 0
        for _ in range(m):
            a, c = round_fn(a)
            last = int(c)
        b, cb = ring_window_packed_xla(
            PackedTable(*(jnp.array(f) for f in t0)), wrap, m
        )
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert last == int(cb), (wrap, m)


def test_reconcile_kernel_bitidentical_to_xla():
    """The doubling-join reconcile must land on the classic loop's fixed
    point (ring, run to convergence), with every row equal."""
    from bullet_tpu.ops.packed import (
        gossip_until_converged_packed,
        reconcile_packed_xla,
    )

    for p, n in ((64, 1024), (8, 256), (48, 2048), (12, 96)):
        t = pack_table(random_dense(p, n, seed=90 + p))
        nb = jnp.asarray(topo.ring(p).neighbors)
        want, _, c_want = gossip_until_converged_packed(
            PackedTable(*(jnp.array(f) for f in t)), nb, "ring", p + 2)
        assert int(c_want) == 0
        got = reconcile_packed_xla(PackedTable(*(jnp.array(f) for f in t)))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), (p, n))
        # join really is global: every row equals row 0
        for f in got:
            np.testing.assert_array_equal(
                np.asarray(f), np.tile(np.asarray(f)[:1], (p, 1))
            )


@pytest.mark.parametrize("wrap", [True, False])
def test_count_changes_probe_matches_round(wrap):
    """The read-only converged() probe must report exactly the change
    count a real round produces — without touching the table."""
    from bullet_tpu.ops.packed import count_changes_round_packed

    t = pack_table(random_dense(16, 512, seed=44))
    before = [np.asarray(f).copy() for f in t]
    round_fn = gossip_round_ring_packed if wrap else gossip_round_chain_packed
    _, c_real = round_fn(t)
    c_probe = count_changes_round_packed(
        PackedTable(*(jnp.array(f) for f in before)), wrap
    )
    assert int(c_real) == int(c_probe)
    for f, b in zip(t, before):  # the probe advanced nothing
        np.testing.assert_array_equal(np.asarray(f), b)
    # converged table probes 0
    from bullet_tpu.ops.packed import gossip_until_converged_packed
    nb = jnp.asarray(topo.ring(16).neighbors)
    done, _, _ = gossip_until_converged_packed(
        PackedTable(*(jnp.array(f) for f in before)), nb,
        "ring" if wrap else "chain", 20)
    assert int(count_changes_round_packed(done, wrap)) == 0


def test_sim_converged_probe():
    sim = PeerNetworkSim(8, capacity=256, topology="ring", layout="packed")
    sim.put(0, "c/x", 3)
    sim.step(rounds=0)  # apply only
    assert not sim.converged()
    sim.run_until_converged()
    assert sim.converged() and sim.tables_equal()
