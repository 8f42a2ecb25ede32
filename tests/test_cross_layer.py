"""Cross-layer bit-identity: the engine's converged state must match two
real networked Bullet peers (full CRT + flood + anti-entropy over sockets)
fed the same op sequence — the SURVEY §4 item (c) harness, with the host db
layer standing in for the Node reference (its behavior is oracle-tested
against the reference decision table in test_crt_oracle.py)."""

import time

import numpy as np
import pytest

import bullet_tpu as bt
from bullet_tpu.models.netsim import PeerNetworkSim

# NOTE on scope: the reference has a second-order quirk (Q2b, documented in
# docs/conflict-resolution.md): after a *dropped* smaller re-put, the stored
# clock object and the clock map de-alias, so the next write at that peer
# unconditionally dominates — making the converged value depend on sync
# timing (genuinely non-deterministic in the reference itself). The fuzz
# below keeps per-peer sequences non-decreasing per key, which avoids drops
# and stays in the region where the reference is deterministic; there both
# layers must agree exactly. test_q2b_dealiasing_demo pins the quirk itself.


def wait_for(predicate, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("layout", ["packed", "rank1"])
def test_live_bridge_mirrors_wire_traffic(layout):
    """attach_live_bridge: a wire-connected db peer becomes a device-resident
    replica — local puts AND network-applied updates stream into the
    engine as they are accepted, and flush() materializes the mirror."""
    from bullet_tpu.models.bridge import attach_live_bridge

    sim = PeerNetworkSim(2, capacity=256, topology="ring", layout=layout)
    p1 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "connect_sync_delay": 600})
    p2 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "peers": [f"tcp://127.0.0.1:{p1.network.port}"],
                    "connect_sync_delay": 600})
    handle = attach_live_bridge(p1, sim, peer=0)
    try:
        assert wait_for(lambda: p1.network.peers and p2.network.peers)
        # local writes on the bridged peer
        p1.get("m/local").put(11)
        p1.get("m/obj").put({"a": 1, "b": "x"})
        # remote writes arriving over the real socket (flood)
        p2.get("m/remote").put(22)
        p2.get("m/deep/leaf").put(True)
        assert wait_for(lambda: p1.store.get("m", {}).get("remote") == 22)
        assert wait_for(
            lambda: (p1.store.get("m", {}).get("deep") or {}).get("leaf")
            is True
        )
        handle.flush()
        assert sim.get(0, "m/local") == 11
        assert sim.get(0, "m/obj") == {"a": 1, "b": "x"}
        assert sim.get(0, "m/remote") == 22
        assert sim.get(0, "m/deep/leaf") is True
        # both engine replicas converged to the mirror
        assert sim.tables_equal()
        # detach stops the stream
        handle.detach()
        p2.get("m/after").put(99)
        assert wait_for(lambda: p1.store.get("m", {}).get("after") == 99)
        sim.run_until_converged()
        assert sim.get(0, "m/after") is None
    finally:
        p1.close()
        p2.close()


def test_live_bridge_multi_writer_convergence_fabric():
    """Two UNCONNECTED db peers each live-bridged to a different engine
    row: the engine's gossip becomes the convergence fabric, merging both
    write streams under reference semantics, and the result dumps back
    into a fresh db instance."""
    from bullet_tpu.models.bridge import attach_live_bridge, dump_sim_into_bullet

    sim = PeerNetworkSim(2, capacity=256, topology="ring", layout="rank1")
    a = bt.create({"storage": False, "disable_network": True})
    b = bt.create({"storage": False, "disable_network": True})
    ha = attach_live_bridge(a, sim, peer=0)
    hb = attach_live_bridge(b, sim, peer=1)
    try:
        a.get("doc/title").put("alpha")
        b.get("doc/title").put("beta")      # conflicting write, other peer
        a.get("doc/by_a").put(1)
        b.get("doc/by_b").put(2)
        ha.flush()
        assert sim.tables_equal()
        # reference value-max: "beta" > "alpha"
        assert sim.get(0, "doc/title") == "beta"
        assert sim.get(1, "doc/title") == "beta"
        assert sim.get(0, "doc/by_a") == 1 and sim.get(0, "doc/by_b") == 2

        out = bt.create({"storage": False, "disable_network": True})
        n = dump_sim_into_bullet(sim, out, peer=0)
        assert n >= 3
        assert out.get("doc/title").value() == "beta"
        out.close()
    finally:
        ha.detach()
        hb.detach()
        a.close()
        b.close()


def test_live_bridge_dominant_regression_contract():
    """Pin the documented live-bridge contract: a clock-DOMINANT network
    update that regresses a leaf to a smaller value replaces it in the db,
    while the engine mirror (reference value-max) keeps the larger value
    until something greater lands. Local re-puts (Q2 aliased clocks =
    value-max on both sides) stay identical."""
    from bullet_tpu.models.bridge import attach_live_bridge

    sim = PeerNetworkSim(2, capacity=128, topology="ring", layout="packed")
    b = bt.create({"storage": False, "disable_network": True})
    handle = attach_live_bridge(b, sim, peer=0)
    try:
        b.get("k").put({"v": 50})
        handle.flush()
        assert sim.get(0, "k/v") == 50

        # a network update whose clock DOMINATES the stored one, carrying
        # a SMALLER value (what a post-sync remote writer can send) —
        # exactly the wire form network.py feeds to set_data
        clock = {pid: n + 1 for pid, n in b.crt.get_vector_clock("k").items()}
        clock["remote-peer"] = 1
        b.set_data(
            "k",
            {"__fromNetwork": True, "__vectorClock": clock, "v": 3},
            broadcast=False,
        )
        assert b.get("k/v").value() == 3          # db regressed (dominance)
        handle.flush()
        assert sim.get(0, "k/v") == 50            # mirror kept value-max

        # a greater write re-synchronizes both sides
        b.get("k").put({"v": 60})
        assert b.get("k/v").value() == 60
        handle.flush()
        assert sim.get(0, "k/v") == 60
    finally:
        handle.detach()
        b.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_networked_db_pair(seed):
    rng = np.random.default_rng(seed)
    keys = [f"data/k{i}" for i in range(6)]
    # concurrent scalar writes at both peers; per-(peer, key) sequences made
    # non-decreasing so no local re-put is dropped (see module note)
    ops = []
    floor = {}
    for _ in range(40):
        who = int(rng.integers(2))
        key = keys[int(rng.integers(len(keys)))]
        value = floor.get((who, key), 0) + int(rng.integers(1, 20))
        floor[(who, key)] = value
        ops.append((who, key, value))

    # --- real networked pair. connect_sync_delay is LARGE on purpose: the
    # automatic post-connect sync must not race the op loop below — a sync
    # landing mid-sequence exchanges clocks early, after which a later
    # write's clock can DOMINATE the other peer's larger value (legitimate
    # reference semantics, but timing-dependent). Deferring all anti-entropy
    # until after the writes keeps the session deterministic: final clocks
    # are concurrent, so resolution is by value — the engine's order.
    p1 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "connect_sync_delay": 600})
    p2 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "peers": [f"tcp://127.0.0.1:{p1.network.port}"],
                    "connect_sync_delay": 600})
    try:
        assert wait_for(lambda: p1.network.peers and p2.network.peers)
        peers = (p1, p2)
        for who, key, value in ops:
            peers[who].set_data(key, value, broadcast=False)  # concurrent
        # anti-entropy until convergence
        for _ in range(6):
            p1.network.request_sync()
            p2.network.request_sync()
            if wait_for(
                lambda: p1.store.get("data") == p2.store.get("data"), timeout=5
            ):
                break
        db_state = {k: p1.store.get("data", {}).get(k.split("/")[1]) for k in keys}
        assert p1.store.get("data") == p2.store.get("data")
    finally:
        p1.close()
        p2.close()

    # --- engine, same ops
    sim = PeerNetworkSim(2, capacity=64, topology="ring")
    for who, key, value in ops:
        sim.put(who, key, value)
    sim.run_until_converged()
    assert sim.tables_equal()
    engine_state = {k: sim.get(0, k) for k in keys}

    assert engine_state == db_state


def test_engine_matches_db_local_quirks(bullet_factory):
    """Single-writer sequences: the db layer's Q2 behavior and the engine's
    value-max must agree on final values."""
    sequences = [
        [5, 3, 7, 2],       # ups and downs -> max 7
        [1, 1, 1],          # idempotent
        [10, 20, 30],       # increasing -> 30
        [9, -4],            # decrease dropped -> 9
    ]
    for i, seq in enumerate(sequences):
        b = bullet_factory()
        sim = PeerNetworkSim(2, capacity=32, topology="ring")
        for v in seq:
            b.get(f"s{i}").put(v)
            sim.put(0, f"s{i}", v)
        sim.run_until_converged()
        assert b.get(f"s{i}").value() == sim.get(1, f"s{i}"), seq


def test_engine_matches_db_mixed_types(bullet_factory):
    """Cross-type conflicts where both layers' orders agree (numbers vs
    numbers, strings vs strings, null vs scalar)."""
    cases = [
        [3, 14, 7],
        ["apple", "zebra", "mango"],
        [5, None],          # null loses
        [True, False],      # bool as numbers: true wins
    ]
    for i, values in enumerate(cases):
        b = bullet_factory()
        sim = PeerNetworkSim(2, capacity=32, topology="ring")
        for v in values:
            b.get(f"m{i}").put(v)
            sim.put(0, f"m{i}", v)
        sim.run_until_converged()
        assert b.get(f"m{i}").value() == sim.get(1, f"m{i}"), values


def test_q2b_dealiasing_demo(bullet_factory):
    """Pin quirk Q2b: a dropped re-put de-aliases the clock objects, so the
    NEXT write wins unconditionally — even a smaller value."""
    b = bullet_factory()
    b.get("q").put(99)
    b.get("q").put(50)  # dropped (Q2) — and de-aliases the clocks
    assert b.get("q").value() == 99
    b.get("q").put(10)  # dominates via the de-aliased clock: accepted!
    assert b.get("q").value() == 10
    b.get("q").put(7)   # re-aliased -> back to value-max: dropped
    assert b.get("q").value() == 10


# ---------------------------------------------------- mixed-type layout fuzz


@pytest.mark.parametrize("seed", [3, 7, 11, 19])
@pytest.mark.parametrize("topology", ["ring", "mesh", "bridge"])
def test_mixed_type_fuzz_dense_vs_packed_vs_oracle(seed, topology):
    """Heavy fuzz: random mixed-type concurrent writes (numbers incl. -0.0 /
    NaN-free floats, unicode strings incl. astral plane, bools, nulls,
    arrays) across peers — the dense and packed engines must converge to
    the identical state, and that state must equal a pure-Python fold under
    the engine's documented total order for every key."""
    rng = np.random.default_rng(seed)
    pool = [
        0, 1, -1, 7, 3.5, -2.25, 1e9, -0.0, 2**40,
        "", "a", "zz", "Ω", "\U0001F600", "�",  # astral vs BMP order
        True, False, None, [1, 2], ["x"],
    ]
    keys = [f"g/k{i}" for i in range(10)]
    ops = []
    for _ in range(120):
        ops.append((
            int(rng.integers(9)),
            keys[int(rng.integers(len(keys)))],
            pool[int(rng.integers(len(pool)))],
        ))

    def run(layout):
        sim = PeerNetworkSim(9, capacity=256, topology=topology, layout=layout)
        for peer, key, value in ops:
            sim.put(peer, key, value)
        sim.run_until_converged()
        assert sim.tables_equal(), (layout, topology)
        return sim, {k: sim.get(0, k) for k in keys}

    dense_sim, dense = run("dense")
    _, packed = run("packed")
    assert dense == packed
    _, ranked = run("rank")
    _, ranked1 = run("rank1")
    assert ranked == packed and ranked1 == packed

    # oracle: fold under the engine's encode order (cls, khi, klo, vid)
    host = dense_sim.host
    expected = {}
    for peer, key, value in ops:
        k = host.encode_value(value)
        prev = expected.get(key)
        if prev is None or k > prev[0]:
            expected[key] = (k, value)
    for key, (_, value) in expected.items():
        got = dense[key]
        if isinstance(value, float) and value == int(value):
            assert got == value  # int/float canonicalization is equality-safe
        else:
            assert got == value, (key, got, value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_ingestion_fuzz_converge_vs_reconcile(seed):
    """Random interleavings of every ingestion surface (scalar puts, tree
    puts, numeric put_bulk, mixed-list put_bulk, remove) must land on ONE
    state: identical across layouts, and identical between the simulated
    convergence and direct reconcile()."""
    import numpy as np

    from bullet_tpu.models.netsim import PeerNetworkSim

    def drive(sim, rng):
        for _ in range(30):
            op = rng.integers(5)
            peer = int(rng.integers(8))
            if op == 0:
                sim.put(peer, f"f/k{int(rng.integers(8))}",
                        float(rng.integers(1000)))
            elif op == 1:
                sim.put(peer, f"t/n{int(rng.integers(3))}", {
                    f"c{i}": {"a": int(rng.integers(50)), "b": f"s{i}"}
                    for i in range(6)
                })
            elif op == 2:
                sim.put_bulk(
                    rng.integers(0, 8, 12).astype(np.int32),
                    [f"f/k{int(i)}" for i in rng.integers(0, 8, 12)],
                    rng.integers(0, 500, 12).astype(np.float64),
                )
            elif op == 3:
                sim.put_bulk(
                    np.asarray([peer] * 4),
                    [f"m/x{int(i)}" for i in rng.integers(0, 5, 4)],
                    [True, None, f"str{int(rng.integers(9))}",
                     float(rng.integers(99))],
                )
            else:
                sim.remove(peer, f"t/n{int(rng.integers(3))}/c1")

    def final_state(layout, finish):
        sim = PeerNetworkSim(8, capacity=2048, topology="ring",
                             layout=layout)
        drive(sim, np.random.default_rng(100 + seed))
        finish(sim)
        assert sim.tables_equal()
        return sim.get(0, "")

    ref = final_state("packed", lambda s: s.run_until_converged())
    for layout, finish in (
        ("packed", lambda s: s.reconcile()),
        ("dense", lambda s: s.run_until_converged()),
        ("dense", lambda s: s.reconcile()),
        ("rank", lambda s: s.run_until_converged()),
        ("rank1", lambda s: s.reconcile()),
    ):
        got = final_state(layout, finish)
        assert got == ref, (layout, seed)


def test_replica_view_serving_facade():
    """handle.view(): a read-only query facade bound to the mirror peer.
    The default apply-only refresh folds queued mirror writes in before
    each query (no explicit flush needed — every mirror write targets the
    bound peer's own row); refresh=None serves the last applied state;
    the facade exposes NO write surface."""
    from bullet_tpu.models.bridge import ReplicaView, attach_live_bridge

    sim = PeerNetworkSim(2, capacity=256, topology="ring", layout="rank1")
    db = bt.create({"storage": False, "disable_network": True})
    handle = attach_live_bridge(db, sim, peer=0)
    try:
        for i, (name, role, age) in enumerate(
            [("ann", "admin", 34), ("bo", "user", 19), ("cy", "admin", 52)]
        ):
            db.get(f"users/{name}/role").put(role)
            db.get(f"users/{name}/age").put(age)

        view = handle.view()  # refresh="apply": no flush() needed
        assert sorted(view.equals("users", "role", "admin")) == [
            "users/ann", "users/cy"]
        assert view.count("users", "role", "admin") == 2
        assert view.range("users", "age", 20, 60) == ["users/ann", "users/cy"]
        assert view.get("users/bo/age") == 19
        assert view.find("users", lambda row: row.get("role") == "user") == "users/bo"
        assert sorted(view.map("users", lambda row: row.get("age"))) == [19, 34, 52]
        assert view.filter("users", lambda row: row.get("age", 0) > 30) == [
            "users/ann", "users/cy"]

        # stale view: refresh=None does NOT see post-snapshot writes
        stale = handle.view(refresh=None)
        db.get("users/dee/role").put("admin")
        assert stale.count("users", "role", "admin") == 2
        assert view.count("users", "role", "admin") == 3  # live view does
        assert stale.count("users", "role", "admin") == 3  # now applied

        # no write surface
        for name in ("put", "put_bulk", "remove", "set_data"):
            assert not hasattr(view, name)
    finally:
        handle.detach()
        db.close()


def test_replica_view_converge_policy_multi_writer():
    """refresh="converge" is the multi-writer policy: the OTHER bridge's
    writes only become visible at this peer through gossip."""
    from bullet_tpu.models.bridge import attach_live_bridge

    sim = PeerNetworkSim(2, capacity=256, topology="ring", layout="rank1")
    a = bt.create({"storage": False, "disable_network": True})
    b = bt.create({"storage": False, "disable_network": True})
    ha = attach_live_bridge(a, sim, peer=0)
    hb = attach_live_bridge(b, sim, peer=1)
    try:
        a.get("k/x").put(1)
        b.get("k/y").put(2)
        apply_only = ha.view()  # peer 0: sees only its own mirror stream
        assert apply_only.get("k/x") == 1
        assert apply_only.get("k/y") is None
        converged = ha.view(refresh="converge")
        assert converged.get("k/y") == 2
        assert apply_only.get("k/y") == 2  # gossip already ran
    finally:
        ha.detach()
        hb.detach()
        a.close()
        b.close()


def test_heterogeneous_validation_policy_over_wire():
    """A validating peer vetoes invalid NETWORK writes the same way it
    vetoes local ones (the Q1 fix applies uniformly): flood AND
    anti-entropy applications of a schema-violating entry are rejected
    with an error event, sync completes without failures or livelock,
    and the divergence is scoped to the rejected path — valid entries
    keep replicating. (Per-node validation policy is a deliberate
    divergence point, documented in docs/validation.md; the reference's
    validation hook is dead — quirk Q1 — so it can never disagree.)"""
    p1 = bt.create({"storage": False, "port": 0, "host": "127.0.0.1"})
    p2 = bt.create({
        "storage": False, "port": 0, "host": "127.0.0.1",
        "peers": [f"tcp://127.0.0.1:{p1.network.port}"],
        "connect_sync_delay": 0.1,
    })
    try:
        p2.defineSchema("user", {
            "type": "object", "required": ["age"],
            "properties": {"age": {"type": "integer", "min": 0}},
        })
        p2.applySchema("users", "user")
        errs = []
        p2.onValidationError("all", lambda e: errs.append(e))

        p1.get("users/ok").put({"age": 30})
        p1.get("users/bad").put({"age": -5})
        deadline = time.time() + 10
        while time.time() < deadline and p2.get("users/ok").value() != {"age": 30}:
            time.sleep(0.05)
        assert p2.get("users/ok").value() == {"age": 30}
        assert p2.get("users/bad").value() in (None, {})  # vetoed (Q3 shell ok)
        assert errs, "flood rejection must fire validation-error handlers"

        # anti-entropy re-offers the entry; the veto must hold and the
        # sync itself must complete cleanly
        p2.network.request_sync()
        deadline = time.time() + 10
        while time.time() < deadline:
            st = p2.network.sync.get_sync_stats()
            if st.get("activeSyncs") == 0 and st.get("totalSyncs", 0) >= 1:
                break
            time.sleep(0.05)
        st = p2.network.sync.get_sync_stats()
        assert st.get("failedSyncs") == 0
        assert p2.get("users/bad").value() in (None, {})
        assert p1.get("users/bad").value() == {"age": -5}  # origin keeps it
    finally:
        p1.close()
        p2.close()
