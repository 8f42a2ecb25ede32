"""Program-level rank1 layout (4 B/entry, single int32 array): every
shared packed-family program must produce ranks bit-identical to the
2-array rank layout when both start from the same rank state — the cv
column is pure payload (rank is a bijection over entries; see ops/rank.py
Rank1Table).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bullet_tpu.ops import packed as pk
from bullet_tpu.ops import rank as rk


def _tables(p, n, seed=0, density=0.6):
    """Matching (Rank1Table, RankTable) over one random rank state. cv is
    a synthetic injection of rank (vid bits = low rank bits) — the shared
    programs never read it except as carried payload."""
    rng = np.random.default_rng(seed)
    rank = np.where(
        rng.random((p, n)) < density,
        rng.integers(1, 1 << 30, (p, n)),
        0,
    ).astype(np.int32)
    cv = np.where(rank > 0, (1 << 28) | (rank & pk.VID_MASK), 0).astype(
        np.int32
    )
    return (
        rk.Rank1Table(jnp.asarray(rank)),
        rk.RankTable(jnp.asarray(rank), jnp.asarray(cv)),
        rank,
        cv,
    )


def _assert_rank_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.rank), np.asarray(b.rank))


def test_merge_xla_parity():
    t1, t2, rank, cv = _tables(16, 512)
    m1, c1 = pk.merge_packed_xla(
        t1, rk.Rank1Table(jnp.roll(t1.rank, 1, 0))
    )
    m2, c2 = pk.merge_packed_xla(
        t2, rk.RankTable(jnp.roll(t2.rank, 1, 0), jnp.roll(t2.cv, 1, 0))
    )
    _assert_rank_equal(m1, m2)
    assert int(c1) == int(c2)


@pytest.mark.parametrize("wrap", [True, False])
def test_round_parity(wrap):
    t1, t2, *_ = _tables(16, 512, seed=1)
    round_fn = pk.gossip_round_ring_packed if wrap else pk.gossip_round_chain_packed
    g1, c1 = round_fn(t1)
    g2, c2 = round_fn(t2)
    _assert_rank_equal(g1, g2)
    assert int(c1) == int(c2)


@pytest.mark.parametrize("kind", ["ring", "chain"])
def test_converge_loop_parity(kind):
    """The compiled convergence loop on both rank arities: identical
    ranks, round counts and residuals."""
    from bullet_tpu.parallel import topology as topo

    t1, t2, *_ = _tables(16, 512, seed=2)
    nb = jnp.asarray(getattr(topo, kind)(16).neighbors)
    f1, r1, c1 = pk.gossip_until_converged_packed(t1, nb, kind, 40)
    f2, r2, c2 = pk.gossip_until_converged_packed(t2, nb, kind, 40)
    _assert_rank_equal(f1, f2)
    assert int(r1) == int(r2) and int(c1) == int(c2) == 0


@pytest.mark.parametrize("wrap", [True, False])
def test_window_fused_parity(wrap):
    """The O(log m) window join on both rank arities: identical ranks,
    identical classic round-m residuals, and bit-identity to the
    sequential classic loop."""
    t1, t2, *_ = _tables(16, 512, seed=6)
    w1, c1 = pk.ring_window_packed_xla(
        rk.Rank1Table(jnp.array(t1.rank)), wrap, 7)
    w2, c2 = pk.ring_window_packed_xla(
        rk.RankTable(jnp.array(t2.rank), jnp.array(t2.cv)), wrap, 7)
    _assert_rank_equal(w1, w2)
    assert int(c1) == int(c2)
    round_fn = pk.gossip_round_ring_packed if wrap else pk.gossip_round_chain_packed
    seq = t1
    for _ in range(7):
        seq, c_last = round_fn(seq)
    _assert_rank_equal(w1, seq)
    assert int(c1) == int(c_last)


@pytest.mark.parametrize("wrap", [True, False])
def test_count_probe_parity(wrap):
    t1, t2, *_ = _tables(16, 512, seed=3)
    c1 = pk.count_changes_round_packed(t1, wrap)
    c2 = pk.count_changes_round_packed(t2, wrap)
    round_fn = pk.gossip_round_ring_packed if wrap else pk.gossip_round_chain_packed
    assert int(c1) == int(c2) == int(round_fn(t1)[1])


@pytest.mark.parametrize("wrap", [True, False])
def test_shardmap_window_parity(wrap):
    """The shard_map window (m rounds per boundary exchange) on both rank
    arities over the virtual mesh: identical ranks and residuals, equal
    to the unsharded window."""
    from bullet_tpu.parallel import shardmap_gossip as smg
    from bullet_tpu.parallel.mesh import make_mesh, shard_table

    t1, t2, *_ = _tables(64, 256, seed=13)
    want, c_want = pk.ring_window_packed_xla(
        rk.Rank1Table(jnp.array(t1.rank)), wrap, 5)
    mesh = make_mesh(8)
    o1, c1 = smg.ring_window_shardmap_packed(shard_table(t1, mesh), mesh,
                                             wrap, 5)
    o2, c2 = smg.ring_window_shardmap_packed(shard_table(t2, mesh), mesh,
                                             wrap, 5)
    _assert_rank_equal(o1, o2)
    _assert_rank_equal(o1, want)
    assert int(c1) == int(c2) == int(c_want)


def test_reconcile_parity():
    t1, t2, *_ = _tables(16, 512, seed=4)
    r1 = pk.reconcile_packed_xla(t1)
    r2 = pk.reconcile_packed_xla(t2)
    _assert_rank_equal(r1, r2)
    # reconcile = the global join: every row identical
    rows = np.asarray(r1.rank)
    assert (rows == rows[0:1]).all()


def _ops(p, n, k, seed=10):
    rng = np.random.default_rng(seed)
    peer = rng.integers(0, p, k).astype(np.int32)
    slot = rng.integers(0, n, k).astype(np.int32)
    oprank = rng.integers(1, 1 << 30, k).astype(np.int32)
    opcv = ((1 << 28) | (oprank & pk.VID_MASK)).astype(np.int32)
    return peer, slot, oprank, opcv


def test_flat_apply_parity():
    p, n = 16, 512
    t1, t2, *_ = _tables(p, n, seed=6)
    peer, slot, oprank, opcv = _ops(p, n, 200)
    p_, s_, r_, cv_ = rk.reduce_flat_ops_rank(peer, slot, oprank, opcv)
    a1, ap1 = rk.apply_flat_rank1_stacked(
        t1, jnp.asarray(np.stack([p_, s_, r_]))
    )
    a2, ap2 = rk.apply_flat_rank_stacked(
        t2, jnp.asarray(np.stack([p_, s_, r_, cv_]))
    )
    _assert_rank_equal(a1, a2)
    assert int(ap1) == int(ap2)


def test_shardmap_ring_parity():
    from bullet_tpu.parallel import shardmap_gossip as smg
    from bullet_tpu.parallel.mesh import make_mesh, shard_table

    t1, t2, *_ = _tables(64, 256, seed=8)
    mesh = make_mesh(8)
    s1 = shard_table(t1, mesh)
    s2 = shard_table(t2, mesh)
    o1, c1 = smg.ring_round_shardmap_packed(s1, mesh, True)
    o2, c2 = smg.ring_round_shardmap_packed(s2, mesh, True)
    _assert_rank_equal(o1, o2)
    assert int(c1) == int(c2)


def test_conversions_roundtrip():
    """pack_to_rank1 / rank1_to_rank round-trip through a real RankIndex."""
    idx = rk.RankIndex()
    rng = np.random.default_rng(9)
    n_vals = 50
    cls = rng.integers(1, 4, n_vals).astype(np.int64)
    khi = rng.integers(-1000, 1000, n_vals).astype(np.int64)
    klo = rng.integers(-1000, 1000, n_vals).astype(np.int64)
    idx.insert_batch(np.arange(n_vals), cls, khi, klo)
    rmap = jnp.asarray(idx.rank_map())
    sranks, svids = idx.inverse_arrays()

    p, n = 4, 128
    vid = rng.integers(0, n_vals, (p, n)).astype(np.int32)
    present = rng.random((p, n)) < 0.5
    cv = np.where(present, (cls[vid].astype(np.int32) << 28) | vid, 0)
    from bullet_tpu.ops.packed import PackedTable

    pt = PackedTable(
        khi=jnp.asarray(np.where(present, khi[vid], 0).astype(np.int32)),
        klo=jnp.asarray(np.where(present, klo[vid], 0).astype(np.int32)),
        cv=jnp.asarray(cv.astype(np.int32)),
    )
    r1 = rk.pack_to_rank1(pt, rmap)
    rt = rk.rank1_to_rank(
        r1, jnp.asarray(sranks), jnp.asarray(svids),
        jnp.asarray(cls.astype(np.int32)),
    )
    np.testing.assert_array_equal(np.asarray(rt.cv), cv.astype(np.int32))
    # host decode agrees
    vids_back = idx.decode_ranks(np.asarray(r1.rank))
    np.testing.assert_array_equal(
        vids_back[present], vid[present].astype(np.int64)
    )
    assert (vids_back[~present] == -1).all()


def test_rekey_rank1_respread():
    """Force a respread and check the stale-rank table re-gathers exactly
    through prev_inverse."""
    idx = rk.RankIndex()
    idx.insert_batch(
        np.arange(3), np.array([2, 2, 2]), np.array([0, 10, 20]),
        np.zeros(3),
    )
    sr0, sv0 = idx.inverse_arrays()
    rmap0 = idx.rank_map()
    p, n = 2, 64
    rng = np.random.default_rng(11)
    vid = rng.integers(0, 3, (p, n))
    present = rng.random((p, n)) < 0.7
    rank = np.where(present, rmap0[vid], 0).astype(np.int32)
    t = rk.Rank1Table(jnp.asarray(rank))

    # exhaust a gap: many new keys between two neighbors until respread
    epoch0 = idx.epoch
    import bullet_tpu.ops.rank as rmod
    old_span = rmod.RANK_SPAN
    try:
        rmod.RANK_SPAN = 1023
        idx._respread()  # shrink the space so gaps exhaust quickly
        rmap0 = idx.rank_map()
        rank = np.where(present, rmap0[vid], 0).astype(np.int32)
        t = rk.Rank1Table(jnp.asarray(rank))
        epoch0 = idx.epoch
        next_vid = 3
        while idx.epoch == epoch0 + 0 or idx.prev_inverse is None:
            idx.insert_batch(
                np.array([next_vid]), np.array([2]),
                np.array([1]), np.array([next_vid]),
            )
            next_vid += 1
            if idx.epoch > epoch0:
                break
            assert next_vid < 2000, "respread never fired"
    finally:
        rmod.RANK_SPAN = old_span
    assert idx.prev_inverse is not None
    osr, osv = idx.prev_inverse
    t2 = rk.rekey_rank1(
        t, jnp.asarray(osr), jnp.asarray(osv), jnp.asarray(idx.rank_map())
    )
    expect = np.where(present, idx.rank_map()[vid], 0).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(t2.rank), expect)
