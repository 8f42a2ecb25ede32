"""Engine property tests: convergence, determinism, topology independence,
and agreement with the reference's converged semantics (SURVEY §4's test
pyramid items (b) and (c))."""

import numpy as np
import pytest

from bullet_tpu.models.netsim import PeerNetworkSim
from bullet_tpu.parallel import topology as topo
from bullet_tpu.utils.jsvalues import js_compare


def fold_expected(values):
    """Reference converged value for concurrent scalar writes = comparator
    max (DESIGN.md reduction)."""
    best = values[0]
    for v in values[1:]:
        if js_compare(v, best) > 0:
            best = v
    return best


@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star", "bridge"])
def test_all_topologies_converge_identically(topology):
    num_peers = 11
    sim = PeerNetworkSim(num_peers, capacity=64, topology=topology)
    rng = np.random.default_rng(42)
    writes = {}
    for _ in range(60):
        peer = int(rng.integers(num_peers))
        key = f"data/k{int(rng.integers(8))}"
        value = float(rng.integers(-50, 50))
        sim.put(peer, key, value)
        writes.setdefault(key, []).append(value)
    sim.run_until_converged()
    assert sim.tables_equal()
    for key, values in writes.items():
        expected = fold_expected(values)
        for peer in (0, num_peers // 2, num_peers - 1):
            assert sim.get(peer, key) == expected, (key, topology)


def test_final_state_topology_independent():
    """Same ops on different connected topologies -> identical fixed point
    (the semilattice makes delivery order irrelevant)."""
    results = []
    for topology in ["ring", "chain", "mesh"]:
        sim = PeerNetworkSim(9, capacity=64, topology=topology)
        rng = np.random.default_rng(7)
        for _ in range(40):
            sim.put(int(rng.integers(9)), f"x/k{int(rng.integers(5))}", int(rng.integers(100)))
        sim.run_until_converged()
        results.append(sim.get(0, "x"))
    assert results[0] == results[1] == results[2]


def test_convergence_rounds_bounded_by_diameter():
    sim = PeerNetworkSim(16, capacity=32, topology="chain")
    sim.put(0, "far", 1)  # must travel 15 hops
    rounds = sim.run_until_converged()
    assert sim.tables_equal()
    assert rounds <= sim.topology.diameter + 1
    assert sim.get(15, "far") == 1


def test_mesh_one_round():
    sim = PeerNetworkSim(8, capacity=32, topology="mesh")
    sim.put(3, "k", "hello")
    sim.step(rounds=1)
    assert sim.tables_equal()
    assert sim.get(0, "k") == "hello"


def test_mixed_types_converge_by_documented_order():
    sim = PeerNetworkSim(4, capacity=32, topology="mesh")
    sim.put(0, "t", None)
    sim.put(1, "t", 50)
    sim.put(2, "t", "zzz")  # strings sort above numbers in the engine order
    sim.run_until_converged()
    assert sim.get(3, "t") == "zzz"


def test_object_puts_deep_merge():
    """Field-disjoint concurrent object writes union (quirk Q4 via the leaf
    model)."""
    sim = PeerNetworkSim(4, capacity=64, topology="ring")
    sim.put(0, "users/a", {"name": "Ann", "age": 30})
    sim.put(2, "users/a", {"email": "a@x.io", "age": 31})
    sim.run_until_converged()
    assert sim.get(1, "users/a") == {"name": "Ann", "age": 31, "email": "a@x.io"}


def test_q2_smaller_reput_dropped_reference_mode():
    sim = PeerNetworkSim(2, capacity=32, topology="ring")
    sim.put(0, "s", 10)
    sim.run_until_converged()
    sim.put(0, "s", 3)
    sim.run_until_converged()
    assert sim.get(1, "s") == 10  # reference quirk Q2 preserved


def test_partition_and_heal():
    """Fault injection: a partitioned bridge cannot converge globally; healing
    the link converges (the experiment docs/network-topologies.md:235-240
    only discusses)."""
    t = topo.bridge((3, 3), 1)
    sim = PeerNetworkSim(t.num_peers, capacity=32, topology=t)
    bridge_peer = t.num_peers - 1
    broken = t.drop_peer(bridge_peer)
    sim.topology = broken
    sim.put(0, "left", 1)
    sim.put(3, "right", 2)
    sim.run_until_converged(max_rounds=10)
    assert sim.get(4, "left") is None  # did not cross the partition
    sim.topology = t  # heal
    sim.run_until_converged()
    assert sim.get(4, "left") == 1
    assert sim.get(0, "right") == 2


def test_determinism_same_seed_same_state():
    def run():
        sim = PeerNetworkSim(6, capacity=64, topology="ring")
        rng = np.random.default_rng(3)
        for _ in range(30):
            sim.put(int(rng.integers(6)), f"d/k{int(rng.integers(4))}", float(rng.standard_normal()))
        sim.run_until_converged()
        return [np.asarray(f) for f in sim.table]

    t1, t2 = run(), run()
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(a, b)


def test_snapshot_restore():
    sim = PeerNetworkSim(4, capacity=32, topology="ring")
    sim.put(0, "a", 1)
    sim.run_until_converged()
    snap = sim.snapshot()
    sim.put(1, "a", 99)
    sim.run_until_converged()
    assert sim.get(2, "a") == 99
    sim.restore(snap)
    assert sim.get(2, "a") == 1


def test_capacity_growth():
    sim = PeerNetworkSim(3, capacity=8, topology="ring")
    for i in range(40):  # exceeds initial capacity
        sim.put(i % 3, f"grow/k{i}", i)
    sim.run_until_converged()
    assert sim.tables_equal()
    assert sim.get(0, "grow/k39") == 39
    assert sim.capacity >= len(sim.host.paths)


def test_string_rebalance_rekeys_table():
    sim = PeerNetworkSim(2, capacity=64, topology="ring")
    sim.put(0, "w", "m")
    sim.run_until_converged()
    # force rank rebalances with adversarial inserts
    s = "m"
    for i in range(64):
        s = s + ("a" if i % 2 else "z")
        sim.put(0, f"w{i}", s)
    sim.run_until_converged()
    assert sim.tables_equal()
    # ordering still correct after rekey: biggest string wins a conflict
    sim.put(0, "battle", "aaa")
    sim.put(1, "battle", "zzz")
    sim.run_until_converged()
    assert sim.get(0, "battle") == "zzz"


def test_subscriptions_fire_on_convergence():
    sim = PeerNetworkSim(4, capacity=32, topology="ring")
    seen = []
    sim.on(3, "watched", seen.append)
    sim.put(0, "watched", 5)
    sim.run_until_converged()
    assert seen == [None, 5]
    sim.put(1, "watched", 2)  # loses in reference mode -> no callback
    sim.run_until_converged()
    assert seen == [None, 5]


def test_engine_queries():
    sim = PeerNetworkSim(4, capacity=128, topology="mesh")
    users = {
        "u1": {"name": "Alice", "age": 28, "role": "admin"},
        "u2": {"name": "Bob", "age": 35, "role": "user"},
        "u3": {"name": "Carol", "age": 42, "role": "user"},
    }
    for uid, data in users.items():
        sim.put(0, f"users/{uid}", data)
    sim.run_until_converged()
    assert sim.equals(2, "users", "role", "user") == ["users/u2", "users/u3"]
    assert sim.range(1, "users", "age", 30, 45) == ["users/u2", "users/u3"]
    assert sim.count(3, "users", "role", "admin") == 1
    # count is a device-side mask+sum (one scalar readback): it must agree
    # with len(equals) on every form, including misses
    assert sim.count(3, "users", "role", "user") == 2
    assert sim.count(3, "users", "role", "nobody") == 0
    assert sim.count(3, "nosuch", "role", "user") == 0
    assert sim.count(3, "users", "nofield", "user") == 0
    sim.put(0, "scores/a", 10)
    sim.put(0, "scores/b", 10)
    sim.run_until_converged()
    assert sim.count(2, "scores", 10) == 2  # leaf form
    assert sim.count(2, "scores", 11) == 0
    assert sim.filter(0, "users", lambda v, k: v.get("age", 0) > 40) == ["users/u3"]
    assert sim.find(0, "users", lambda v, k: v.get("name") == "Bob") == "users/u2"
    names = sim.map(0, "users", lambda v, k: v.get("name"))
    assert sorted(names) == ["Alice", "Bob", "Carol"]


# ------------------------------------------ changed-slot subscription dispatch


def test_subscriptions_dispatch_only_changed():
    """1k subscriptions, one write: exactly one subtree re-read (O(changed)
    dispatch, VERDICT r1 #7) and only the right callback fires."""
    sim = PeerNetworkSim(4, capacity=4096, topology="ring")
    fired = []
    for i in range(1000):
        sim.put(0, f"watch/w{i}/v", i)
    sim.run_until_converged()
    for i in range(1000):
        sim.on(1, f"watch/w{i}/v", lambda v, i=i: fired.append((i, v)))
    assert len(fired) == 1000  # immediate fire on subscribe
    fired.clear()
    sim.step()  # first step after subscribing establishes the slot baseline
    assert fired == []  # values unchanged -> no callbacks

    reads = []
    orig_get = sim.get
    sim.get = lambda peer, path="": (reads.append(path), orig_get(peer, path))[1]

    sim.put(2, "watch/w42/v", 10_042)
    sim.run_until_converged()
    assert fired == [(42, 10_042)]
    watch_reads = [p for p in reads if p.startswith("watch/")]
    assert watch_reads == ["watch/w42/v"], watch_reads[:5]

    # a no-op step re-reads nothing and fires nothing
    reads.clear()
    sim.step()
    assert fired == [(42, 10_042)]
    assert [p for p in reads if p.startswith("watch/")] == []


def test_subscription_subtree_and_new_descendants():
    """A parent-path watch fires when any descendant changes — including
    descendants created AFTER the subscription (watch index rebuilds when
    the path tree grows)."""
    sim = PeerNetworkSim(2, capacity=256, topology="ring")
    sim.put(0, "team/a/name", "alpha")
    sim.run_until_converged()
    seen = []
    sim.on(1, "team", seen.append)
    assert seen == [{"a": {"name": "alpha"}}]
    sim.put(0, "team/b/name", "beta")  # new descendant path
    sim.run_until_converged()
    assert seen[-1] == {"a": {"name": "alpha"}, "b": {"name": "beta"}}
    sim.put(0, "team/a/name", "gamma")
    sim.run_until_converged()
    assert seen[-1]["a"]["name"] == "gamma"


def test_subscriptions_on_packed_layout():
    sim = PeerNetworkSim(2, capacity=128, topology="ring", layout="packed")
    sim.put(0, "k/x", 1)
    sim.run_until_converged()
    seen = []
    sim.on(1, "k/x", seen.append)
    sim.put(0, "k/x", 5)
    sim.run_until_converged()
    assert seen == [1, 5]


def test_subscription_off_stops_dispatch():
    sim = PeerNetworkSim(2, capacity=128, topology="ring")
    seen = []
    cb = seen.append
    sim.on(0, "q/x", cb)
    sim.put(0, "q/x", 1)
    sim.run_until_converged()
    assert seen == [None, 1]
    sim.off(0, "q/x", cb)
    sim.put(0, "q/x", 2)
    sim.run_until_converged()
    assert seen == [None, 1]


def test_bulk_writes_respect_put_hooks():
    """Code-review r2: put hooks must veto/mutate bulk rows too (scalar and
    bulk paths previously enforced different policies)."""
    sim = PeerNetworkSim(2, capacity=128, topology="ring")
    audited = []
    sim.use("put", lambda path, data, peer: (
        False if path.startswith("blocked") else None))
    sim.use("afterPut", lambda path, data, peer: audited.append(path))
    import numpy as np
    sim.put_bulk(np.array([0, 1], dtype=np.int32),
                 ["blocked/a", "open/b"], np.array([1.0, 2.0]))
    sim.run_until_converged()
    assert sim.get(0, "blocked/a") is None
    assert sim.get(0, "open/b") == 2.0
    assert audited == ["open/b"]


def test_last_residual_honest_at_round_cap():
    """Code-review r2: last_residual must not claim 0 when max_rounds cut
    convergence short."""
    sim = PeerNetworkSim(16, capacity=64, topology="ring")
    sim.put(0, "far/x", 99)
    sim.run_until_converged(max_rounds=1)  # diameter 8: one round can't finish
    assert sim.last_residual > 0
    sim.run_until_converged()
    assert sim.last_residual == 0
    assert sim.tables_equal()


def test_reconcile_matches_converged_state():
    """reconcile() must land on exactly the state run_until_converged
    reaches (topology-independent fixed point), across layouts, modes,
    lean, and topologies — without simulating rounds."""
    for kw, topo_name in (
        (dict(layout="packed"), "ring"),
        (dict(layout="packed"), "star"),
        (dict(layout="rank"), "star"),
        (dict(layout="rank1"), "ring"),
        (dict(layout="dense", mode="reference"), "chain"),
        (dict(layout="dense", mode="lww"), "mesh"),
        (dict(layout="dense", mode="reference", lean_gossip=True), "ring"),
    ):
        kw.setdefault("mode", "reference")

        def load(s):
            rng = np.random.default_rng(77)
            for _ in range(60):
                s.put(int(rng.integers(8)), f"r/k{int(rng.integers(10))}",
                      int(rng.integers(10**6)))

        a = PeerNetworkSim(8, capacity=2048, topology=topo_name, **kw)
        b = PeerNetworkSim(8, capacity=2048, topology=topo_name, **kw)
        load(a), load(b)
        a.run_until_converged()
        b.reconcile()
        assert b.tables_equal()
        lean = kw.get("lean_gossip", False)
        if lean:
            # lean contract: only the 4 value-key arrays are exchanged;
            # writer/ctr/tick stay local and differ between protocols
            cmp_a, cmp_b = a.table[:4], b.table[:4]
        else:
            # priority orders are total, so the full entry (metadata
            # included, where the layout carries it) must bit-match
            cmp_a, cmp_b = tuple(a.table), tuple(b.table)
        for x, y in zip(cmp_a, cmp_b):
            np.testing.assert_array_equal(
                np.asarray(x), np.asarray(y), (kw, topo_name))
        assert b.get(3, "r/k4") == a.get(3, "r/k4")
        assert b.last_residual == 0


def test_reconcile_handles_partitions():
    """reconcile() on a partitioned ring lands each component on its own
    join — the same fixed point run_until_converged reaches (deeper fuzz
    coverage in test_reconcile_weak.py)."""
    from bullet_tpu.parallel import topology as topo2

    t = topo2.ring(8).drop_links([(0, 1), (4, 5)])  # two components
    assert not t.is_connected()
    sim = PeerNetworkSim(8, capacity=256, topology=t, layout="packed")
    ref = PeerNetworkSim(8, capacity=256, topology=t, layout="packed")
    for s in (sim, ref):
        s.put(0, "x", 1)
        s.put(5, "x", 7)
    sim.reconcile()
    ref.run_until_converged()
    for x, y in zip(sim.table, ref.table):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # components are {1,2,3,4} and {5,6,7,0}: the writes (peers 0 and 5)
    # both sit in the second, which joins to 7; the first saw neither
    assert sim.get(6, "x") == 7 and sim.get(0, "x") == 7
    assert sim.get(2, "x") is None


def test_reconcile_applies_pending_and_notifies():
    sim = PeerNetworkSim(8, capacity=256, topology="ring", layout="packed")
    seen = []
    sim.on(2, "a/b", seen.append)  # fires immediately with None
    sim.put(0, "a/b", 41)
    sim.reconcile()
    assert sim.get(7, "a/b") == 41
    assert seen == [None, 41]
    assert sim.converged()
    # an incremental write after reconcile converges as usual
    sim.put(1, "a/b", 99)
    sim.run_until_converged()
    assert sim.tables_equal() and sim.get(0, "a/b") == 99


def test_reconcile_directed_topology_respects_reachability():
    """Gossip is pull-based: on a weakly-connected directed graph the
    fixed point is NOT the global join — each peer's is the join over its
    reachable set, which reconcile now computes via the SCC condensation
    (round-3 generalization; fuzz coverage in test_reconcile_weak.py)."""
    adj = np.zeros((4, 4), dtype=bool)
    for p in range(3):
        adj[p, p + 1] = True  # p pulls from p+1 only; nothing reaches 3's
    t = topo.from_adjacency(adj, name="directed-chain")
    assert not t.is_connected()
    sim = PeerNetworkSim(4, capacity=64, topology=t, layout="dense")
    sim.put(0, "y", 5)
    sim.put(3, "z", 9)
    sim.reconcile()
    assert sim.get(0, "z") == 9  # 0 reaches 3
    assert sim.get(3, "y") is None  # nothing reaches back up
    assert sim.last_residual == 0
    # and the symmetric chain still counts as connected
    assert topo.chain(4).is_connected()


def test_get_bulk_matches_get():
    """get_bulk: one gather for K (peer, path) pairs — values must match
    per-pair get() across layouts, including absent/unknown/null paths,
    interior nodes (None), int-slot form, and single-int peer broadcast."""
    for layout in ("dense", "packed", "rank", "rank1"):
        sim = PeerNetworkSim(4, capacity=256, topology="ring", layout=layout)
        sim.put(0, "a/x", 1)
        sim.put(1, "a/y", 2.5)
        sim.put(2, "b/s", "str")
        sim.put(3, "b/n", None)
        sim.run_until_converged()

        peers = [0, 1, 2, 3, 0]
        paths = ["a/x", "a/y", "b/s", "b/n", "nosuch/p"]
        got = sim.get_bulk(peers, paths)
        want = [sim.get(p, q) for p, q in zip(peers, paths)]
        assert got == want == [1, 2.5, "str", None, None], (layout, got)

        # interior node -> None from get_bulk (point reads only)
        assert sim.get_bulk([0], ["a"]) == [None]
        # single-int peer broadcasts; repeated values decode once
        assert sim.get_bulk(2, ["a/x", "a/x", "b/s"]) == [1, 1, "str"]
        # pre-interned slot-id form
        import numpy as np_

        slots = np_.asarray(
            [sim.host.paths.lookup("a/x"), sim.host.paths.lookup("b/s")],
            dtype=np_.int32,
        )
        assert sim.get_bulk(1, slots) == [1, "str"]


def test_get_bulk_hooks():
    """Get hooks apply per pair: path rewrite feeds the gather, afterGet
    rewrites each value."""
    sim = PeerNetworkSim(2, capacity=128, topology="ring")
    sim.put(0, "real/v", 10)
    sim.run_until_converged()
    sim.hooks.use(
        "get", lambda path, data: "real/v" if path == "alias" else path
    )
    sim.hooks.use(
        "afterGet",
        lambda path, data: data * 2 if isinstance(data, int) else data,
    )
    assert sim.get_bulk(0, ["alias", "real/v"]) == [20, 20]


@pytest.mark.parametrize(
    "layout,mesh_devices",
    [("dense", None), ("packed", None), ("rank1", None), ("rank1", 8)],
)
def test_lossy_network_converges_to_same_fixed_point(layout, mesh_devices):
    """Eventual consistency under message loss: a sim whose links drop
    randomly (and asymmetrically — gossip is pull-based, so directed
    loss is meaningful) for many rounds must still land on EXACTLY the
    fixed point an undisturbed twin reaches, once connectivity returns.
    This generalizes the topology-independence invariant to TIME-VARYING
    topologies: merges are joins, so lost rounds delay but never skew
    the converged state (reference behavior: flood relays tolerate
    arbitrary drop/duplication, bullet-network.js:332-346)."""
    num_peers = 8
    mode = "reference"
    kw = {} if layout == "dense" else {"layout": layout}
    if mesh_devices:
        kw["mesh_devices"] = mesh_devices  # lossy rounds ride shard_map too
    full = topo.ring(num_peers)
    sim = PeerNetworkSim(num_peers, capacity=128, topology=full, mode=mode, **kw)
    twin = PeerNetworkSim(num_peers, capacity=128, topology=full, mode=mode, **kw)
    rng = np.random.default_rng(7)
    for _ in range(50):
        peer = int(rng.integers(num_peers))
        key = f"k/{int(rng.integers(12))}"
        val = float(rng.integers(-1000, 1000))
        sim.put(peer, key, val)
        twin.put(peer, key, val)

    adj_full = full.adjacency()
    for _ in range(20):
        # each round: an independent random subset of DIRECTED links up
        # (~50% loss), including rounds that disconnect the graph
        keep = rng.random(adj_full.shape) < 0.5
        adj = adj_full & keep
        np.fill_diagonal(adj, False)
        sim.topology = topo.from_adjacency(adj, name="lossy")
        sim.step(1)
    sim.topology = full  # connectivity returns
    sim.run_until_converged()
    twin.run_until_converged()

    assert sim.tables_equal() and twin.tables_equal()
    for a, b in zip(sim.table, twin.table):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
