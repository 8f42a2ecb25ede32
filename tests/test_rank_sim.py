"""Sim-level rank layouts: PeerNetworkSim(layout="rank"/"rank1") must be
exact behavioral twins of layout="packed" — converged cv tables
bit-identical, reads/queries/reconcile/checkpoints agreeing — while
storing 8 B/entry (rank) or 4 B/entry (rank1).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bullet_tpu.models.netsim import PeerNetworkSim
from bullet_tpu.ops import packed as pk
from bullet_tpu.ops import rank as rk


VALS = ["alice", "bob", 3.5, -7, 0, True, False, None, "zed", 1e300, -0.5]

LAYOUTS = ["rank", "rank1"]


def _seed(sim, rng, n_writes=150, peers=None):
    peers = peers if peers is not None else sim.num_peers
    for _ in range(n_writes):
        peer = int(rng.integers(0, peers))
        path = f"users/u{int(rng.integers(0, 15))}/f{int(rng.integers(0, 3))}"
        sim.put(peer, path, VALS[int(rng.integers(0, len(VALS)))])


def _pair(topology="ring", n=8, seed=0, layout="rank", **kw):
    sp = PeerNetworkSim(n, capacity=128, topology=topology,
                        layout="packed", **kw)
    sr = PeerNetworkSim(n, capacity=128, topology=topology,
                        layout=layout, **kw)
    rng1, rng2 = np.random.default_rng(seed), np.random.default_rng(seed)
    _seed(sp, rng1)
    _seed(sr, rng2)
    return sp, sr


def _cv_of(sim):
    """The [P, N] cv array in every layout: rank1 rebuilds it through the
    RankIndex inverse (rank is a bijection over entries)."""
    t = sim.table
    if hasattr(t, "cv"):
        return np.asarray(t.cv)
    rank = np.asarray(t.rank)
    vid = sim.rank_index.decode_ranks(rank)
    cls_map, _, _ = sim.host.key_tables()
    safe = np.maximum(vid, 0)
    return np.where(
        vid >= 0, (cls_map[safe].astype(np.int64) << pk.CV_SHIFT) | safe, 0
    ).astype(np.int32)


def _assert_cv_equal(sp, sr):
    np.testing.assert_array_equal(_cv_of(sp), _cv_of(sr))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("topology", ["ring", "chain", "mesh", "star"])
def test_converged_state_matches_packed(topology, layout):
    sp, sr = _pair(topology, seed=1, layout=layout)
    rp = sp.run_until_converged()
    rr = sr.run_until_converged()
    assert rp == rr
    _assert_cv_equal(sp, sr)
    assert sp.tables_equal() and sr.tables_equal()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_rounds_match_packed(layout):
    sp, sr = _pair("ring", seed=2, layout=layout)
    for _ in range(4):
        a = sp.step(rounds=1)
        b = sr.step(rounds=1)
        assert a == b
        _assert_cv_equal(sp, sr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reads_and_get_bulk_match_packed(layout):
    sp, sr = _pair("ring", seed=3, layout=layout)
    sp.run_until_converged()
    sr.run_until_converged()
    paths = [f"users/u{u}/f{f}" for u in range(15) for f in range(3)]
    assert sp.get_bulk(0, paths) == sr.get_bulk(0, paths)
    assert sp.get(1) == sr.get(1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reconcile_matches_packed_any_topology(layout):
    from bullet_tpu.parallel import topology as topo

    rng = np.random.default_rng(4)
    # random directed topology (possibly weak): exercises _reconcile_weak
    n = 6
    adj = rng.random((n, n)) < 0.25
    np.fill_diagonal(adj, False)
    t = topo.from_adjacency(adj, name="fuzz-directed")
    sp = PeerNetworkSim(n, capacity=128, topology=t, layout="packed")
    sr = PeerNetworkSim(n, capacity=128, topology=t, layout=layout)
    _seed(sp, np.random.default_rng(5), 60)
    _seed(sr, np.random.default_rng(5), 60)
    sp.reconcile()
    sr.reconcile()
    _assert_cv_equal(sp, sr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rank_respread_mid_stream(monkeypatch, layout):
    """Tiny RANK_SPAN forces respreads during normal operation; the device
    re-key must keep the sim bit-identical to packed throughout."""
    monkeypatch.setattr(rk, "RANK_SPAN", 1023)
    sp = PeerNetworkSim(4, capacity=128, topology="ring", layout="packed")
    sr = PeerNetworkSim(4, capacity=128, topology="ring", layout=layout)
    rng1, rng2 = np.random.default_rng(6), np.random.default_rng(6)
    for round_ in range(6):
        for sim, rng in ((sp, rng1), (sr, rng2)):
            for _ in range(30):
                peer = int(rng.integers(0, 4))
                # fresh float values every round: new vids keep landing
                # between existing ranks until a gap exhausts
                val = float(rng.random())
                sim.put(peer, f"m/k{int(rng.integers(0, 9))}", val)
        sp.run_until_converged()
        sr.run_until_converged()
        _assert_cv_equal(sp, sr)
    assert sr.rank_index.epoch > 1  # at least one respread actually fired


@pytest.mark.parametrize("layout", LAYOUTS)
def test_string_rebalance_needs_no_device_rekey(layout):
    """Interning strings out of lexicographic order forces string-rank
    respreads (host.needs_rekey); the rank table must stay correct with no
    khi/klo on device."""
    sp = PeerNetworkSim(4, capacity=256, topology="ring", layout="packed")
    sr = PeerNetworkSim(4, capacity=256, topology="ring", layout=layout)
    import random

    names = [f"s{i:04d}" for i in range(300)]
    random.Random(7).shuffle(names)
    for i, s in enumerate(names):
        sp.put(i % 4, f"w/p{i % 37}", s)
        sr.put(i % 4, f"w/p{i % 37}", s)
        if i % 90 == 0:
            sp.run_until_converged()
            sr.run_until_converged()
            _assert_cv_equal(sp, sr)
    sp.run_until_converged()
    sr.run_until_converged()
    _assert_cv_equal(sp, sr)
    assert sp.get(2) == sr.get(2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_put_bulk_matches_packed(layout):
    sp = PeerNetworkSim(8, capacity=1024, topology="ring", layout="packed")
    sr = PeerNetworkSim(8, capacity=1024, topology="ring", layout=layout)
    rng = np.random.default_rng(8)
    k = 5000
    peers = rng.integers(0, 8, k).astype(np.int32)
    paths = [f"t/r{i % 700}" for i in range(k)]
    vals = rng.normal(size=k)
    sp.put_bulk(peers, paths, vals)
    sr.put_bulk(peers, paths, vals)
    sp.run_until_converged()
    sr.run_until_converged()
    _assert_cv_equal(sp, sr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_queries_match_packed(layout):
    sp, sr = _pair("ring", seed=9, layout=layout)
    sp.run_until_converged()
    sr.run_until_converged()
    a, b = sp, sr
    assert a.count(0, "users", "f0") == b.count(0, "users", "f0")
    ea = a.equals(0, "users", "f0", 3.5)
    eb = b.equals(0, "users", "f0", 3.5)
    assert sorted(ea) == sorted(eb)
    ra = a.range(0, "users", "f1", -10, 10)
    rb = b.range(0, "users", "f1", -10, 10)
    assert sorted(ra) == sorted(rb)
    fa = a.filter(0, "users", lambda v, k: isinstance(v.get("f2"), str))
    fb = b.filter(0, "users", lambda v, k: isinstance(v.get("f2"), str))
    assert sorted(fa) == sorted(fb)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ingress_validation_and_hooks_match_packed(layout):
    """Schema vetoes and traced put transforms run BEFORE rank stamping —
    vetoed ops (cls=0) must never land on the rank layouts, and mutated
    values must intern + rank exactly like packed's."""
    def build(lay):
        s = PeerNetworkSim(4, capacity=256, topology="ring", layout=lay)
        s.define_schema("aged", {"properties": {"age": {"type": "number"}}})
        s.apply_schema("users", "aged")
        return s

    sp, sr = build("packed"), build(layout)
    for s in (sp, sr):
        assert s.put(0, "users/u1/age", 30)
        assert not s.put(1, "users/u2/age", "nope")  # typed veto
        s.put_bulk(
            np.array([0, 1], dtype=np.int32),
            ["users/u3/age", "users/u4/age"],
            np.array([40.0, 55.5]),
        )
        s.run_until_converged()
    assert sp.stats["ops_rejected"] == sr.stats["ops_rejected"]
    _assert_cv_equal(sp, sr)
    assert sr.get(3, "users/u2/age") is None
    assert sr.get(3, "users/u4/age") == 55.5

    # traced put transform (the jit pipeline between drain and apply):
    # clamp numbers to 100 — vetoes/mutations happen before rank stamping
    import jax.numpy as jnp

    from bullet_tpu.utils.encode import CLS_NUMBER, number_key

    sp2, sr2 = build("packed"), build(layout)
    cap_hi, cap_lo = number_key(100.0)
    for s in (sp2, sr2):
        cap_vid = s.host.encode_value(100.0)[3]

        def clamp(ops, struct, cv=cap_vid):
            too_big = (ops.cls == CLS_NUMBER) & (
                (ops.khi > cap_hi)
                | ((ops.khi == cap_hi) & (ops.klo > cap_lo))
            )
            return ops._replace(
                khi=jnp.where(too_big, cap_hi, ops.khi),
                klo=jnp.where(too_big, cap_lo, ops.klo),
                vid=jnp.where(too_big, cv, ops.vid),
            )

        s.use_traced_put(clamp)
        s.put(0, "m/a", 50)
        s.put(0, "m/b", 12345)
        s.run_until_converged()
    _assert_cv_equal(sp2, sr2)
    assert sr2.get(1, "m/a") == 50
    assert sr2.get(1, "m/b") == 100


@pytest.mark.parametrize("topology", ["mesh", "ring"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_interleaved_soak_matches_packed(monkeypatch, layout, topology):
    """Randomized interleaving of puts (floats/strings/dicts/nulls), bare
    steps, convergences, reconciles, snapshots, and restores — with a tiny
    RANK_SPAN so respreads fire mid-soak and capacity growth triggers.
    Every checkpoint compares the decoded cv tables against packed. The
    ring variant additionally soaks fast_forward: the rank-side sim jumps
    with the O(log k) window path wherever the packed side steps
    sequentially, so the bit-identity contract is exercised under
    respreads, capacity growth, and snapshot/restore interleavings."""
    monkeypatch.setattr(rk, "RANK_SPAN", 8191)
    rng = np.random.default_rng(42)
    sp = PeerNetworkSim(5, capacity=64, topology=topology, layout="packed")
    sr = PeerNetworkSim(5, capacity=64, topology=topology, layout=layout)
    strings = [f"s{i:03d}" for i in range(200)]
    rng.shuffle(strings)
    si = 0
    snapshots = []
    for step in range(60):
        action = rng.random()
        if action < 0.55:
            for _ in range(int(rng.integers(1, 20))):
                peer = int(rng.integers(0, 5))
                path = f"d{int(rng.integers(0, 4))}/k{int(rng.integers(0, 50))}"
                r = rng.random()
                if r < 0.4:
                    v = float(rng.random())
                elif r < 0.6 and si < len(strings):
                    v = strings[si]
                    si += 1
                elif r < 0.7:
                    v = {"a": int(rng.integers(5)), "b": bool(rng.integers(2))}
                elif r < 0.8:
                    v = None
                else:
                    v = int(rng.integers(-5, 5))
                sp.put(peer, path, v)
                sr.put(peer, path, v)
        elif action < 0.7:
            n = int(rng.integers(0, 3))
            sp.step(rounds=n)
            if topology == "ring" and n:
                sr.fast_forward(n)  # must bit-match the packed step(n)
            else:
                sr.step(rounds=n)
        elif action < 0.82:
            sp.run_until_converged()
            sr.run_until_converged()
            _assert_cv_equal(sp, sr)
        elif action < 0.9:
            sp.reconcile()
            sr.reconcile()
            _assert_cv_equal(sp, sr)
        elif action < 0.95 and snapshots:
            a, b = snapshots[int(rng.integers(0, len(snapshots)))]
            sp.restore(a)
            sr.restore(b)
            _assert_cv_equal(sp, sr)
        else:
            snapshots.append((sp.snapshot(), sr.snapshot()))
            if len(snapshots) > 3:
                snapshots.pop(0)
    sp.run_until_converged()
    sr.run_until_converged()
    _assert_cv_equal(sp, sr)
    assert sp.get(0) == sr.get(0)
    assert sr.rank_index.epoch >= 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_serializer_and_remove_match_packed(layout):
    sp = PeerNetworkSim(2, capacity=128, topology="ring", layout="packed")
    sr = PeerNetworkSim(2, capacity=128, topology="ring", layout=layout)
    for s in (sp, sr):
        s.put(0, "cfg/name", "alpha")
        s.put(0, "cfg/n", 7)
        s.put(1, "cfg/flag", True)
        s.run_until_converged()
    assert sp.export_to_json(0) == sr.export_to_json(0)
    assert sp.export_to_xml(0, "cfg") == sr.export_to_xml(0, "cfg")
    for s in (sp, sr):
        assert s.remove(0, "cfg/name")
        s.run_until_converged()
    _assert_cv_equal(sp, sr)
    assert sp.get(1, "cfg") == sr.get(1, "cfg")


def test_rank1_rank_native_queries_edge_cases():
    """The rank1 equals/range/count path compares RANKS, not keys — pin
    the edge cases: unseen values, boolean-vs-0 identity (same order key,
    different vids), uninterned range bounds, empty intervals."""
    sp = PeerNetworkSim(4, capacity=256, topology="ring", layout="packed")
    s1 = PeerNetworkSim(4, capacity=256, topology="ring", layout="rank1")
    rng = np.random.default_rng(21)
    vals = [0, False, True, 1, -0.5, 2.25, 7, 1e300, "x", None, 3.5]
    for i in range(120):
        peer = int(rng.integers(0, 4))
        path = f"q/i{int(rng.integers(0, 20))}/v"
        v = vals[int(rng.integers(0, len(vals)))]
        sp.put(peer, path, v)
        s1.put(peer, path, v)
    sp.run_until_converged()
    s1.run_until_converged()
    for probe in vals + [99, "unseen", 2.250001]:
        assert sp.equals(0, "q", "v", probe) == s1.equals(0, "q", "v", probe), probe
        assert sp.count(0, "q", "v", probe) == s1.count(0, "q", "v", probe), probe
    for lo, hi in [(0, 1), (-1, 0), (0.5, 3), (-1e309, 1e309), (5, 4),
                   (2.25, 2.25), (1e299, 1e301)]:
        assert sp.range(0, "q", "v", lo, hi) == s1.range(0, "q", "v", lo, hi), (lo, hi)
    # leaf (no-field) forms
    sp.put(0, "r/leaf", 5)
    s1.put(0, "r/leaf", 5)
    sp.run_until_converged()
    s1.run_until_converged()
    assert sp.equals(1, "r", 5) == s1.equals(1, "r", 5)
    assert sp.range(1, "r", 4, 6) == s1.range(1, "r", 4, 6)
    assert sp.count(1, "r", 5) == s1.count(1, "r", 5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_roundtrip_rank(tmp_path, layout):
    from bullet_tpu.models.checkpoint import load_checkpoint, save_checkpoint

    sr = PeerNetworkSim(4, capacity=128, topology="ring", layout=layout)
    _seed(sr, np.random.default_rng(10), 80)
    sr.run_until_converged()
    save_checkpoint(sr, str(tmp_path / "ck"))
    loaded = load_checkpoint(str(tmp_path / "ck"))
    assert loaded.layout == layout
    np.testing.assert_array_equal(_cv_of(sr), _cv_of(loaded))
    if layout == "rank":
        # restored ranks coherent with the rebuilt index
        cv = np.asarray(loaded.table.cv)
        present = (cv >> 28) > 0
        rmap = loaded.rank_index.rank_map()
        np.testing.assert_array_equal(
            np.asarray(loaded.table.rank)[present],
            rmap[cv & ((1 << 28) - 1)][present],
        )
    # and the loaded sim keeps working
    loaded.put(0, "post/restore", 42)
    loaded.run_until_converged()
    assert loaded.get(3, "post/restore") == 42


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spmd_rank_sim_matches_packed(layout):
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    kw = dict(mesh_devices=8, use_shard_map=True)
    sp = PeerNetworkSim(64, capacity=256, topology="ring",
                        layout="packed", **kw)
    sr = PeerNetworkSim(64, capacity=256, topology="ring",
                        layout=layout, **kw)
    rng1, rng2 = np.random.default_rng(11), np.random.default_rng(11)
    _seed(sp, rng1, 120, peers=64)
    _seed(sr, rng2, 120, peers=64)
    name_p, _ = sp._convergence_strategy()
    name_r, _ = sr._convergence_strategy()
    assert name_p == name_r == "packed-loop"
    rp = sp.run_until_converged()
    rr = sr.run_until_converged()
    assert rp == rr
    _assert_cv_equal(sp, sr)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_data_mesh_without_shardmap(layout):
    """mesh_devices WITHOUT use_shard_map: the whole-table packed-loop
    row on a device-put sharded table (XLA-inferred collectives)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    sim = PeerNetworkSim(16, capacity=128, topology="ring", layout=layout,
                         mesh_devices=8)
    assert sim._convergence_strategy()[0] == "packed-loop"
    for p in range(16):
        sim.put(p, f"n/p{p}", p * 2)
    sim.run_until_converged()
    assert sim.tables_equal()
    assert len(sim.table[0].devices()) == 8
    assert sim.get(0, "n/p15") == 30


def test_rank_table_arity():
    sr = PeerNetworkSim(4, capacity=128, topology="ring", layout="rank")
    assert len(sr.table) == 2
    assert sr.table._fields == ("rank", "cv")
    s1 = PeerNetworkSim(4, capacity=128, topology="ring", layout="rank1")
    assert len(s1.table) == 1
    assert s1.table._fields == ("rank",)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_snapshot_restore_across_respread(monkeypatch, layout):
    """A snapshot taken before a rank respread must restore correctly
    after it: restore detects the epoch change and re-gathers ranks (via
    the cv column for rank, via the snapshot's own inverse for rank1)."""
    monkeypatch.setattr(rk, "RANK_SPAN", 2047)
    sr = PeerNetworkSim(4, capacity=256, topology="ring", layout=layout)
    sp = PeerNetworkSim(4, capacity=256, topology="ring", layout="packed")
    rng1, rng2 = np.random.default_rng(13), np.random.default_rng(13)
    _seed(sr, rng1, 60, peers=4)
    _seed(sp, rng2, 60, peers=4)
    # pre-intern every path both sims will touch so the interim writes
    # (which only sr receives) can't skew slot assignment between the two
    # sims — slot ids are first-appearance order in the host interner
    for sim in (sr, sp):
        for k in range(9):
            sim.intern_path(f"m/k{k}")
        for k in range(6):
            sim.intern_path(f"z/k{k}")
    sr.run_until_converged()
    sp.run_until_converged()
    snap_r = sr.snapshot()
    snap_p = sp.snapshot()
    epoch0 = sr.rank_index.epoch

    # new fresh-float writes split gaps until the rank space respreads
    rng = np.random.default_rng(14)
    while sr.rank_index.epoch == epoch0:
        for _ in range(40):
            peer = int(rng.integers(0, 4))
            val = float(rng.random())
            sr.put(peer, f"m/k{int(rng.integers(0, 9))}", val)
        sr.run_until_converged()
        assert sr.rank_index.epoch < epoch0 + 50, "respread never fired"

    sr.restore(snap_r)
    sp.restore(snap_p)
    # the restored table must decode identically to the packed restore
    _assert_cv_equal(sp, sr)
    if layout == "rank":
        # and the rank column must be coherent with the CURRENT index
        cv = np.asarray(sr.table.cv)
        present = (cv >> pk.CV_SHIFT) > 0
        rmap = sr.rank_index.rank_map()
        np.testing.assert_array_equal(
            np.asarray(sr.table.rank)[present],
            rmap[cv & pk.VID_MASK][present],
        )
    # and new writes + convergence still bit-match packed
    for sim, rg in ((sr, np.random.default_rng(15)),
                    (sp, np.random.default_rng(15))):
        for _ in range(30):
            sim.put(int(rg.integers(0, 4)), f"z/k{int(rg.integers(0, 6))}",
                    VALS[int(rg.integers(0, len(VALS)))])
        sim.run_until_converged()
    _assert_cv_equal(sp, sr)
