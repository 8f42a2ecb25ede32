"""Worker for the multi-process jax.distributed smoke test (spawned by
tests/test_multihost_smoke.py, one OS process per simulated host).

Each process brings 2 virtual CPU devices; jax.distributed stitches them
into one 4-device global mesh. The worker covers the multi-device paths
across the real process boundary, each bit-checked against the unsharded
twin computed locally: a dense shard_map ring round, the packed shard_map
convergence loop (final state AND round count), the packed doubling-join
reconcile (XLA-inferred and shard_map), the dense shard_map convergence
loop, the RANK and RANK1 layouts' loop + reconcile (through the same
generic collectives), and the shard_map window fast_forward.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    coordinator, process_id = sys.argv[1], int(sys.argv[2])

    from bullet_tpu.parallel.multihost import (
        global_mesh,
        host_info,
        initialize_multihost,
        is_multihost,
    )

    initialize_multihost(coordinator, num_processes=2, process_id=process_id)
    assert is_multihost(), host_info()
    info = host_info()
    assert info["process_count"] == 2, info
    assert info["local_devices"] == 2, info
    assert info["global_devices"] == 4, info

    import numpy as np

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from bullet_tpu.ops.merge import TableState
    from bullet_tpu.parallel.gossip import gossip_round_ring
    from bullet_tpu.parallel.mesh import PEER_AXIS
    from bullet_tpu.parallel.shardmap_gossip import ring_round_shardmap

    mesh = global_mesh()
    assert mesh.devices.size == 4, mesh

    p, n = 8, 64
    rng = np.random.default_rng(0)  # same seed on every process

    def field(lo, hi):
        return rng.integers(lo, hi, (p, n), dtype=np.int32)

    cls = field(0, 4)
    host_table = [cls]
    for lo, hi in ((-50, 50), (-50, 50), (0, 30), (0, p), (0, 9), (0, 5)):
        host_table.append(np.where(cls > 0, field(lo, hi), 0))

    sharding = NamedSharding(mesh, PartitionSpec(PEER_AXIS, None))
    global_table = TableState(
        *(
            jax.make_array_from_callback(
                (p, n), sharding, lambda idx, f=f: f[idx]
            )
            for f in host_table
        )
    )

    merged, changed = ring_round_shardmap(global_table, mesh, mode="reference")

    # expected: the unsharded round on the full table, computed locally
    expected, c_ref = gossip_round_ring(
        TableState(*(jnp.asarray(f) for f in host_table)), "reference"
    )
    assert int(changed) == int(c_ref), (int(changed), int(c_ref))

    def check_shards(got, exp, names):
        for name, got_f, exp_f in zip(names, got, exp):
            exp_np = np.asarray(exp_f)
            for shard in got_f.addressable_shards:
                rows = shard.index[0]
                np.testing.assert_array_equal(
                    np.asarray(shard.data), exp_np[rows], err_msg=name
                )

    check_shards(merged, expected, TableState._fields)

    # ---- packed shard_map convergence loop across the process boundary ----
    from bullet_tpu.ops.packed import (
        PackedTable,
        gossip_until_converged_packed,
        pack_cv,
        reconcile_packed_xla,
    )
    from bullet_tpu.parallel import topology as topo
    from bullet_tpu.parallel.shardmap_gossip import reconcile_shardmap_packed

    pp, nn = 32, 256  # per-device block 8 rows
    cls = rng.integers(0, 4, (pp, nn), dtype=np.int32)
    present = cls > 0
    khi = np.where(present, rng.integers(-50, 50, (pp, nn)), 0).astype(np.int32)
    klo = np.where(present, rng.integers(-50, 50, (pp, nn)), 0).astype(np.int32)
    vid = np.where(present, rng.integers(1, 1 << 16, (pp, nn)), 0).astype(np.int32)
    host_packed = [khi, klo]

    psharding = NamedSharding(mesh, PartitionSpec(PEER_AXIS, None))
    local_packed = PackedTable(
        jnp.asarray(khi), jnp.asarray(klo),
        pack_cv(jnp.asarray(cls), jnp.asarray(vid)),
    )
    cv_np = np.asarray(local_packed.cv)
    host_packed.append(cv_np)

    def sharded(tcls, fields):
        return tcls(
            *(
                jax.make_array_from_callback(
                    (pp, nn), psharding, lambda idx, f=f: f[idx]
                )
                for f in fields
            )
        )

    ring_nb = jnp.asarray(topo.ring(pp).neighbors)

    def converge(tbl, spmd_mesh=None):
        return gossip_until_converged_packed(
            tbl, ring_nb, "ring", 64, spmd_mesh=spmd_mesh
        )

    got_tbl, got_rounds, got_changed = converge(
        sharded(PackedTable, host_packed), mesh
    )
    exp_tbl, exp_rounds, exp_changed = converge(local_packed)
    assert int(got_rounds) == int(exp_rounds), (
        int(got_rounds), int(exp_rounds))
    assert int(got_changed) == int(exp_changed) == 0
    check_shards(got_tbl, exp_tbl, PackedTable._fields)

    # ---- packed reconcile (doubling join) across the process boundary ----
    got_rec = reconcile_packed_xla(sharded(PackedTable, host_packed))
    exp_rec = reconcile_packed_xla(
        PackedTable(
            jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(cv_np)
        )
    )
    check_shards(got_rec, exp_rec, PackedTable._fields)
    # reconcile and the converged loop agree (all-reachable ring)
    check_shards(got_tbl, exp_rec, PackedTable._fields)
    got_srec = reconcile_shardmap_packed(sharded(PackedTable, host_packed), mesh)
    check_shards(got_srec, exp_rec, PackedTable._fields)

    # ---- dense shard_map convergence loop across the process boundary ----
    from bullet_tpu.parallel.gossip import gossip_until_converged_device

    pd, nd = 32, 256
    cls = rng.integers(0, 4, (pd, nd), dtype=np.int32)
    dense_fields = [cls]
    for lo, hi in ((-50, 50), (-50, 50), (0, 30), (0, pd), (0, 9), (0, 5)):
        dense_fields.append(
            np.where(cls > 0, rng.integers(lo, hi, (pd, nd)), 0).astype(
                np.int32
            )
        )
    got_dtbl, got_drounds, got_dchanged = gossip_until_converged_device(
        sharded(TableState, dense_fields), ring_nb, "ring", "reference", 64,
        spmd_mesh=mesh,
    )
    exp_dtbl, exp_drounds, exp_dchanged = gossip_until_converged_device(
        TableState(*(jnp.asarray(f) for f in dense_fields)), ring_nb,
        "ring", "reference", 64,
    )
    assert int(got_drounds) == int(exp_drounds), (
        int(got_drounds), int(exp_drounds))
    assert int(got_dchanged) == int(exp_dchanged) == 0
    check_shards(got_dtbl, exp_dtbl, TableState._fields)

    # ---- RANK layout (8 B/entry, single-compare merges) across the
    # process boundary: shard_map loop + doubling-join reconcile,
    # each bit-checked shard-by-shard against the locally computed
    # unsharded rank twin (state AND round count). The vid space gets a
    # DETERMINISTIC synthetic rank order shared by both processes (rank
    # semantics only need a total order with distinct ranks per vid;
    # rank-vs-packed state parity is covered by tests/test_rank*.py).
    from bullet_tpu.ops.rank import RankIndex, RankTable, pack_to_rank

    ridx = RankIndex()  # same synthetic keys on every process
    n_vals = 1 << 16
    ridx.insert_batch(
        np.arange(n_vals), np.ones(n_vals, np.int32),
        np.zeros(n_vals, np.int32), np.arange(n_vals, dtype=np.int32),
    )
    rmap = jnp.asarray(ridx.rank_map())
    local_rank = pack_to_rank(
        PackedTable(
            jnp.asarray(host_packed[0]),
            jnp.asarray(host_packed[1]),
            jnp.asarray(cv_np),
        ),
        rmap,
    )
    host_rank = [np.asarray(local_rank.rank), cv_np]
    got_rtbl, got_rrounds, got_rchanged = converge(
        sharded(RankTable, host_rank), mesh
    )
    exp_rtbl, exp_rrounds, exp_rchanged = converge(
        RankTable(*(jnp.asarray(f) for f in host_rank))
    )
    assert int(got_rrounds) == int(exp_rrounds), (
        int(got_rrounds), int(exp_rrounds))
    assert int(got_rchanged) == int(exp_rchanged) == 0
    check_shards(got_rtbl, exp_rtbl, RankTable._fields)

    got_rrec = reconcile_packed_xla(sharded(RankTable, host_rank))
    exp_rrec = reconcile_packed_xla(
        RankTable(*(jnp.asarray(f) for f in host_rank))
    )
    check_shards(got_rrec, exp_rrec, RankTable._fields)

    # ---- RANK1 layout (4 B/entry, the rank alone) across the process
    # boundary: the 1-field table through the same shard_map loop
    # and reconcile, bit-checked against the unsharded rank1 twin.
    from bullet_tpu.ops.rank import Rank1Table

    host_rank1 = [np.asarray(local_rank.rank)]
    got_1tbl, got_1rounds, got_1changed = converge(
        sharded(Rank1Table, host_rank1), mesh
    )
    exp_1tbl, exp_1rounds, exp_1changed = converge(
        Rank1Table(jnp.asarray(host_rank1[0]))
    )
    assert int(got_1rounds) == int(exp_1rounds) == int(exp_rrounds), (
        int(got_1rounds), int(exp_1rounds), int(exp_rrounds))
    assert int(got_1changed) == int(exp_1changed) == 0
    check_shards(got_1tbl, exp_1tbl, Rank1Table._fields)
    # the rank1 loop landed on the SAME ranks as the 2-field run
    # (compare the LOCAL unsharded twins — the global arrays' remote
    # shards are not addressable from this process)
    np.testing.assert_array_equal(
        np.asarray(exp_1tbl.rank), np.asarray(exp_rtbl.rank)
    )

    got_1rec = reconcile_packed_xla(sharded(Rank1Table, host_rank1))
    exp_1rec = reconcile_packed_xla(Rank1Table(jnp.asarray(host_rank1[0])))
    check_shards(got_1rec, exp_1rec, Rank1Table._fields)

    # ---- SPMD window fast_forward path across the process boundary ----
    # m rounds per ONE boundary collective (m-row slab ppermute + local
    # window join): state AND classic round-m residual must bit-match m
    # sequential unsharded rounds. m=8 == the per-device row count (the
    # slab is a device's whole block — the depth cap boundary).
    from bullet_tpu.ops.packed import gossip_round_ring_packed
    from bullet_tpu.parallel.shardmap_gossip import (
        ring_window_shardmap_packed,
    )

    for m in (3, 8):
        got_wtbl, got_wres = ring_window_shardmap_packed(
            sharded(Rank1Table, host_rank1), mesh, True, m
        )
        exp_w = Rank1Table(jnp.asarray(host_rank1[0]))
        exp_wres = None
        for _ in range(m):
            exp_w, exp_wres = gossip_round_ring_packed(exp_w)
        assert int(got_wres) == int(exp_wres), (
            m, int(got_wres), int(exp_wres))
        check_shards(got_wtbl, exp_w, Rank1Table._fields)

    print(f"worker {process_id}: OK", flush=True)


if __name__ == "__main__":
    main()
