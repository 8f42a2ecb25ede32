"""Rank layout (ops.rank): bit-parity with the packed layout.

The rank table's converged cv arrays must be bit-identical to the packed
layout's on every shared program — the rank is a pure re-encoding of
the (cls, khi, klo, vid) order (see ops/rank.py docstring). cv carries
(cls, vid) and khi/klo are functions of vid, so cv equality IS full-state
equality.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bullet_tpu.ops import packed as pk
from bullet_tpu.ops import rank as rk


def make_world(rng, n_vals=40):
    """Random value universe: (cls, khi, klo) per vid, with deliberate
    key collisions across distinct vids (the bool-vs-number tie quirk)."""
    cls = rng.integers(1, 4, n_vals).astype(np.int32)
    khi = rng.integers(-3, 3, n_vals).astype(np.int32)
    klo = rng.integers(-3, 3, n_vals).astype(np.int32)
    idx = rk.RankIndex()
    idx.insert_batch(np.arange(n_vals), cls, khi, klo)
    return cls, khi, klo, idx


def rand_packed(rng, p, n, cls, khi, klo, density=0.7):
    vid = rng.integers(0, len(cls), (p, n))
    present = rng.random((p, n)) < density
    c = np.where(present, cls[vid], 0).astype(np.int32)
    return pk.PackedTable(
        jnp.asarray(np.where(present, khi[vid], 0).astype(np.int32)),
        jnp.asarray(np.where(present, klo[vid], 0).astype(np.int32)),
        jnp.asarray(((c.astype(np.int64) << pk.CV_SHIFT) |
                     np.where(present, vid, 0)).astype(np.int32)),
    )


def to_rank(pt, idx):
    return rk.pack_to_rank(
        pk.PackedTable(*(jnp.array(f) for f in pt)),
        jnp.asarray(idx.rank_map()),
    )


def assert_cv_equal(rt, pt_expected):
    np.testing.assert_array_equal(np.asarray(rt.cv), np.asarray(pt_expected.cv))


def test_rank_index_order_matches_packed_chain():
    rng = np.random.default_rng(1)
    cls, khi, klo, idx = make_world(rng, 200)
    rmap = idx.rank_map()
    # rank order must equal (cls, khi, klo, vid) lexicographic order
    order_key = sorted(
        range(200), key=lambda v: (cls[v], khi[v], klo[v], v)
    )
    order_rank = sorted(range(200), key=lambda v: rmap[v])
    assert order_key == order_rank
    assert rmap[order_key[0]] >= 1


def test_rank_index_incremental_vs_bulk():
    rng = np.random.default_rng(2)
    cls = rng.integers(1, 4, 300).astype(np.int32)
    khi = rng.integers(-2, 2, 300).astype(np.int32)
    klo = rng.integers(-2, 2, 300).astype(np.int32)
    inc = rk.RankIndex()
    for s in range(0, 300, 17):
        e = min(s + 17, 300)
        inc.insert_batch(np.arange(s, e), cls[s:e], khi[s:e], klo[s:e])
    rmap = inc.rank_map()
    order_key = sorted(
        range(300), key=lambda v: (cls[v], khi[v], klo[v], v)
    )
    order_rank = sorted(range(300), key=lambda v: rmap[v])
    assert order_key == order_rank


def test_rank_index_respread_on_exhausted_gap(monkeypatch):
    monkeypatch.setattr(rk, "RANK_SPAN", 63)
    idx = rk.RankIndex()
    idx.insert_batch([0, 1], [1, 1], [0, 0], [0, 100])
    assert not idx.needs_rekey
    # ascending klo inserts squeeze ever-closer to the fixed upper
    # neighbor: the gap halves each time and must exhaust
    respread_seen = False
    mids = list(range(1, 10))
    for i, mid in enumerate(mids):
        idx.insert_batch([2 + i], [1], [0], [mid])
        respread_seen = respread_seen or idx.needs_rekey
    assert respread_seen
    rmap = idx.rank_map()
    keys = [(1, 0, 0, 0), (1, 0, 100, 1)] + [
        (1, 0, m, 2 + i) for i, m in enumerate(mids)
    ]
    order_key = sorted(range(len(keys)), key=lambda i: keys[i])
    order_rank = sorted(range(len(keys)), key=lambda i: rmap[keys[i][3]])
    assert [keys[i][3] for i in order_key] == [
        keys[i][3] for i in order_rank
    ]


@pytest.mark.parametrize("kind", ["ring", "chain", "mesh"])
def test_gossip_round_parity(kind):
    rng = np.random.default_rng(3)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 256, cls, khi, klo)
    rt = to_rank(pt, idx)
    fn = {
        "ring": pk.gossip_round_ring_packed,
        "chain": pk.gossip_round_chain_packed,
        "mesh": pk.gossip_round_mesh_packed,
    }[kind]
    mp, cp = fn(pt)
    mr, cr = fn(rt)
    assert_cv_equal(mr, mp)
    assert int(cp) == int(cr)
    assert isinstance(mr, rk.RankTable)


def test_gossip_round_generic_parity():
    rng = np.random.default_rng(4)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 12, 128, cls, khi, klo)
    rt = to_rank(pt, idx)
    neighbors = rng.integers(-1, 12, (12, 3)).astype(np.int32)
    mp, cp = pk.gossip_round_generic_packed(pt, jnp.asarray(neighbors))
    mr, cr = pk.gossip_round_generic_packed(rt, jnp.asarray(neighbors))
    assert_cv_equal(mr, mp)
    assert int(cp) == int(cr)


@pytest.mark.parametrize("max_rounds", [64, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_converge_loop_parity(max_rounds, wrap):
    """The compiled convergence loop, run to the fixed point or cut off:
    same state, round count and residual on packed and rank."""
    from bullet_tpu.parallel import topology as topo_mod

    rng = np.random.default_rng(7 + max_rounds)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 512, cls, khi, klo, density=0.3)
    rt = to_rank(pt, idx)
    kind = "ring" if wrap else "chain"
    nb = jnp.asarray(getattr(topo_mod, kind)(16).neighbors)
    tp, rp, lp = pk.gossip_until_converged_packed(
        pk.PackedTable(*(jnp.array(f) for f in pt)), nb, kind, max_rounds)
    tr, rr, lr = pk.gossip_until_converged_packed(rt, nb, kind, max_rounds)
    assert_cv_equal(tr, tp)
    assert int(rp) == int(rr)
    assert int(lp) == int(lr)


@pytest.mark.parametrize("wrap", [True, False])
def test_window_rank_parity(wrap):
    """The radius-m window join on packed and rank: same state and
    round-m residual."""
    rng = np.random.default_rng(20)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 512, cls, khi, klo, density=0.3)
    rt = to_rank(pt, idx)
    wp, cp = pk.ring_window_packed_xla(
        pk.PackedTable(*(jnp.array(f) for f in pt)), wrap, 9)
    wr, cr = pk.ring_window_packed_xla(
        rk.RankTable(*(jnp.array(f) for f in rt)), wrap, 9)
    assert_cv_equal(wr, wp)
    assert int(cp) == int(cr)


def test_reconcile_parity():
    rng = np.random.default_rng(9)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 256, cls, khi, klo)
    rt = to_rank(pt, idx)
    rp = pk.reconcile_packed_xla(pk.PackedTable(*(jnp.array(f) for f in pt)))
    rr = pk.reconcile_packed_xla(rk.RankTable(*(jnp.array(f) for f in rt)))
    assert_cv_equal(rr, rp)


def test_apply_flat_parity():
    rng = np.random.default_rng(10)
    cls, khi, klo, idx = make_world(rng)
    p, n = 8, 256
    pt = rand_packed(rng, p, n, cls, khi, klo, density=0.4)
    rt = to_rank(pt, idx)
    rmap = idx.rank_map()

    k = 500
    peer = rng.integers(0, p, k).astype(np.int32)
    slot = rng.integers(0, n, k).astype(np.int32)
    vid = rng.integers(0, len(cls), k).astype(np.int32)
    ocls = cls[vid]

    red_p = pk.reduce_flat_ops(peer, slot, ocls, khi[vid], klo[vid], vid)
    red_r = rk.reduce_flat_ops_rank(
        peer, slot, rmap[vid],
        ((ocls.astype(np.int64) << pk.CV_SHIFT) | vid).astype(np.int32),
    )
    assert red_p is not None and red_r is not None
    pw, sw, khw, klw, cvw = red_p
    pw2, sw2, rkw, cvw2 = red_r
    np.testing.assert_array_equal(pw, pw2)
    np.testing.assert_array_equal(sw, sw2)
    np.testing.assert_array_equal(cvw, cvw2)
    np.testing.assert_array_equal(rmap[cvw & pk.VID_MASK], rkw)

    tp, ap = pk.apply_flat_packed(
        pk.PackedTable(*(jnp.array(f) for f in pt)),
        *(jnp.asarray(a) for a in red_p),
    )
    tr, ar = rk.apply_flat_rank(rt, *(jnp.asarray(a) for a in red_r))
    assert_cv_equal(tr, tp)
    assert int(ap) == int(ar)
    # rank field consistent with the LUT everywhere present
    cvr = np.asarray(tr.cv)
    present = (cvr >> pk.CV_SHIFT) > 0
    np.testing.assert_array_equal(
        np.asarray(tr.rank)[present], rmap[cvr & pk.VID_MASK][present]
    )


def test_rekey_after_respread(monkeypatch):
    monkeypatch.setattr(rk, "RANK_SPAN", 127)
    rng = np.random.default_rng(11)
    idx = rk.RankIndex()
    cls0 = np.array([1, 1, 2], np.int32)
    khi0 = np.array([0, 4, 0], np.int32)
    klo0 = np.array([0, 0, 0], np.int32)
    idx.insert_batch([0, 1, 2], cls0, khi0, klo0)
    pt = rand_packed(rng, 8, 128, cls0, khi0, klo0)
    rt = to_rank(pt, idx)

    # new values squeeze ranks until a respread fires
    all_cls, all_khi, all_klo = [list(a) for a in (cls0, khi0, klo0)]
    v = 3
    while not idx.needs_rekey:
        idx.insert_batch([v], [1], [rng.integers(0, 4)], [0])
        all_cls.append(1)
        all_khi.append(int(idx._sk1[0]) * 0 + 0)  # placeholder, unused below
        all_klo.append(0)
        v += 1
        assert v < 300
    rt = rk.rekey_rank(rt, jnp.asarray(idx.rank_map()))
    idx.needs_rekey = False
    # after the re-key, the table's ranks match the fresh LUT and the
    # merge outcome still matches packed
    cvr = np.asarray(rt.cv)
    present = (cvr >> pk.CV_SHIFT) > 0
    np.testing.assert_array_equal(
        np.asarray(rt.rank)[present],
        idx.rank_map()[cvr & pk.VID_MASK][present],
    )
    mp, cp = pk.gossip_round_ring_packed(pt)
    mr, cr = pk.gossip_round_ring_packed(rt)
    assert_cv_equal(mr, mp)
    assert int(cp) == int(cr)


def test_converged_fixed_point_parity():
    """Full convergence on a ring: classic packed loop vs rank loop."""
    rng = np.random.default_rng(12)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 256, cls, khi, klo, density=0.5)
    rt = to_rank(pt, idx)

    tp = pk.PackedTable(*(jnp.array(f) for f in pt))
    tr = rk.RankTable(*(jnp.array(f) for f in rt))
    for _ in range(40):
        tp, cp = pk.gossip_round_ring_packed(tp)
        tr, cr = pk.gossip_round_ring_packed(tr)
        assert int(cp) == int(cr)
        if int(cp) == 0:
            break
    assert int(cp) == 0
    assert_cv_equal(tr, tp)


# ---------------------------------------------------------------- spmd

def _mesh8():
    from bullet_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


@pytest.mark.parametrize("topo", ["ring", "chain", "mesh", "star", "generic"])
def test_shardmap_round_rank_parity(topo):
    from bullet_tpu.parallel import shardmap_gossip as smg

    rng = np.random.default_rng(30)
    cls, khi, klo, idx = make_world(rng)
    pt = rand_packed(rng, 16, 256, cls, khi, klo, density=0.5)
    rt = to_rank(pt, idx)
    mesh = _mesh8()
    if topo == "ring":
        f = lambda t: smg.ring_round_shardmap_packed(t, mesh, wrap=True)
    elif topo == "chain":
        f = lambda t: smg.ring_round_shardmap_packed(t, mesh, wrap=False)
    elif topo == "mesh":
        f = lambda t: smg.mesh_round_shardmap_packed(t, mesh)
    elif topo == "star":
        f = lambda t: smg.star_round_shardmap_packed(t, mesh, hub=3)
    else:
        nbrs = jnp.asarray(
            rng.integers(-1, 16, (16, 3)).astype(np.int32)
        )
        f = lambda t: smg.generic_round_shardmap_packed(t, nbrs, mesh)
    mp, cp = f(pt)
    mr, cr = f(rt)
    assert_cv_equal(mr, mp)
    assert int(cp) == int(cr)
    assert isinstance(mr, rk.RankTable)


@pytest.mark.parametrize("kind", ["ring", "chain"])
def test_shardmap_loop_rank_parity(kind):
    """The shard_map convergence loop on packed and rank: same state,
    round count and residual."""
    from bullet_tpu.parallel import topology as topo_mod

    rng = np.random.default_rng(31)
    cls, khi, klo, idx = make_world(rng)
    p, n = 64, 256
    pt = rand_packed(rng, p, n, cls, khi, klo, density=0.3)
    rt = to_rank(pt, idx)
    mesh = _mesh8()
    nb = jnp.asarray(getattr(topo_mod, kind)(p).neighbors)
    tp, rp, lp = pk.gossip_until_converged_packed(
        pk.PackedTable(*(jnp.array(f) for f in pt)), nb, kind, 2 * p,
        spmd_mesh=mesh)
    tr, rr, lr = pk.gossip_until_converged_packed(
        rk.RankTable(*(jnp.array(f) for f in rt)), nb, kind, 2 * p,
        spmd_mesh=mesh)
    assert_cv_equal(tr, tp)
    assert int(rp) == int(rr)
    assert int(lp) == int(lr) == 0


def test_native_reduce_rank_parity():
    """native.reduce_flat_ops_rank must be bit-identical to the numpy
    fallback."""
    from bullet_tpu import native

    if native.load() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(40)
    k, p, n = 50_000, 32, 2048
    peer = rng.integers(0, p, k).astype(np.int32)
    slot = rng.integers(0, n, k).astype(np.int32)
    rank = rng.integers(0, 1 << 30, k).astype(np.int32)
    cls = rng.integers(0, 4, k).astype(np.int32)
    cv = ((cls.astype(np.int64) << pk.CV_SHIFT)
          | rng.integers(0, 1 << 20, k)).astype(np.int32)
    import os

    fast = rk.reduce_flat_ops_rank(peer, slot, rank, cv)
    os.environ["BULLET_NO_NATIVE"] = "1"
    native._lib, native._load_failed = None, False
    try:
        slow = rk.reduce_flat_ops_rank(peer, slot, rank, cv)
    finally:
        del os.environ["BULLET_NO_NATIVE"]
        native._lib, native._load_failed = None, False
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)


def test_native_rank_insert_batch_parity():
    """native.rank_insert_batch must leave the RankIndex bit-identical to
    the numpy insert path: merged sorted arrays, assigned ranks, respread
    decisions, epochs, and prev_inverse snapshots — under heavy key
    collisions, permuted input vid order, and gap-exhaustion pressure."""
    from bullet_tpu import native

    if native.load() is None:
        pytest.skip("native library unavailable")

    def snap(ri):
        return (
            ri._svids.copy(), ri._sk1.copy(), ri._sk2.copy(),
            ri._sranks.copy(),  # the merged-order rank sequence feeds
            # every rank1 decode — a native/numpy divergence here must
            # fail the fuzz, not just in rank_of
            ri._rank_of.copy(), ri.epoch, ri.needs_rekey,
            None if ri.prev_inverse is None else tuple(
                a.copy() for a in ri.prev_inverse
            ),
        )

    rng = np.random.default_rng(41)
    orig = native.rank_insert_batch
    try:
        for trial in range(25):
            span = int(rng.choice([rk.RANK_SPAN, 8191, 127]))
            old_span, rk.RANK_SPAN = rk.RANK_SPAN, span
            try:
                a, b = rk.RankIndex(), rk.RankIndex()
                next_vid = 0
                for _ in range(int(rng.integers(1, 5))):
                    k = int(rng.integers(1, 200))
                    vids = np.arange(
                        next_vid, next_vid + k, dtype=np.int64
                    )
                    next_vid += k
                    if rng.random() < 0.3:
                        vids = rng.permutation(vids)
                    cls = rng.integers(1, 4, k).astype(np.int64)
                    khi = rng.integers(-3, 3, k).astype(np.int64)
                    klo = rng.integers(-2, 2, k).astype(np.int64)
                    native.rank_insert_batch = orig
                    a.insert_batch(vids, cls, khi, klo)
                    native.rank_insert_batch = lambda *args, **kw: None
                    b.insert_batch(vids, cls, khi, klo)
                    for x, y in zip(snap(a), snap(b)):
                        if isinstance(x, np.ndarray):
                            np.testing.assert_array_equal(x, y)
                        elif isinstance(x, tuple):
                            assert y is not None
                            for p_, q_ in zip(x, y):
                                np.testing.assert_array_equal(p_, q_)
                        else:
                            assert x == y
            finally:
                rk.RANK_SPAN = old_span
    finally:
        native.rank_insert_batch = orig
