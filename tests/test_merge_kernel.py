"""Merge correctness: XLA vs a numpy oracle, semilattice laws, and
agreement with the reference decision table for scalar leaves."""

import numpy as np
import pytest

import jax.numpy as jnp

from bullet_tpu.ops.merge import (
    TableState,
    init_table,
    merge_tables_xla,
)


def random_table(rng, p=8, n=128, writers=4):
    def arr(lo, hi):
        return jnp.asarray(rng.integers(lo, hi, size=(p, n), dtype=np.int32))

    cls = arr(0, 4)
    return TableState(
        cls=cls,
        khi=arr(-100, 100),
        klo=arr(-100, 100),
        vid=arr(0, 50),
        writer=arr(0, writers),
        ctr=arr(0, 20),
        tick=arr(0, 10),
    )


@pytest.mark.parametrize("mode", ["reference", "lww"])
def test_pallas_matches_xla(mode):
    """The merge against a per-entry numpy oracle: b's entry replaces a's
    iff b's priority tuple is strictly greater."""
    rng = np.random.default_rng(0)
    a, b = random_table(rng), random_table(rng)
    m_x, c_x = merge_tables_xla(a, b, mode)
    order = (("cls", "khi", "klo", "vid", "writer", "ctr")
             if mode == "reference"
             else ("ctr", "cls", "khi", "klo", "vid", "writer"))
    na = {f: np.asarray(getattr(a, f)) for f in TableState._fields}
    nb = {f: np.asarray(getattr(b, f)) for f in TableState._fields}
    key_a = np.stack([na[f] for f in order], axis=-1).reshape(-1, 6)
    key_b = np.stack([nb[f] for f in order], axis=-1).reshape(-1, 6)
    take_b = np.array([tuple(kb) > tuple(ka) for ka, kb in zip(key_a, key_b)])
    take_b = take_b.reshape(na["cls"].shape)
    for f in TableState._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(m_x, f)), np.where(take_b, nb[f], na[f]))
    assert int(c_x) == int(take_b.sum())


@pytest.mark.parametrize("mode", ["reference", "lww"])
def test_semilattice_laws(mode):
    """Associativity, commutativity, idempotence — the convergence proof
    obligations from SURVEY §7 ("Gossip vs. flood")."""
    rng = np.random.default_rng(1)
    a, b, c = (random_table(rng, p=4, n=64) for _ in range(3))

    def merge(x, y):
        return merge_tables_xla(x, y, mode)[0]

    def eq(x, y):
        return all(
            np.array_equal(np.asarray(fx), np.asarray(fy)) for fx, fy in zip(x, y)
        )

    assert eq(merge(a, a), a)  # idempotent
    assert eq(merge(a, b), merge(b, a))  # commutative
    assert eq(merge(merge(a, b), c), merge(a, merge(b, c)))  # associative


def test_changed_count_is_strict_wins():
    a = init_table(2, 128)
    b = init_table(2, 128)
    b = b._replace(
        cls=b.cls.at[0, :5].set(2), vid=b.vid.at[0, :5].set(7), khi=b.khi.at[0, :5].set(1)
    )
    merged, changed = merge_tables_xla(a, b, "reference")
    assert int(changed) == 5
    # merging the result with b again changes nothing (absorption)
    _, changed2 = merge_tables_xla(merged, b, "reference")
    assert int(changed2) == 0


def test_reference_mode_value_order_decides():
    """Scalar conflicts resolve by encoded value order — the converged
    behavior of bullet-crt.js resolve (SURVEY quirk Q2)."""
    a = init_table(1, 128)
    b = init_table(1, 128)
    # a holds number key (5, 0); b holds number key (9, 0): b must win
    a = a._replace(cls=a.cls.at[0, 0].set(2), khi=a.khi.at[0, 0].set(5), vid=a.vid.at[0, 0].set(1))
    b = b._replace(cls=b.cls.at[0, 0].set(2), khi=b.khi.at[0, 0].set(9), vid=b.vid.at[0, 0].set(2))
    merged, _ = merge_tables_xla(a, b, "reference")
    assert int(merged.vid[0, 0]) == 2
    # lww with equal ctr falls back to the same value order
    merged2, _ = merge_tables_xla(a, b, "lww")
    assert int(merged2.vid[0, 0]) == 2


def test_lww_mode_timestamp_dominates_value():
    a = init_table(1, 128)
    b = init_table(1, 128)
    a = a._replace(cls=a.cls.at[0, 0].set(2), khi=a.khi.at[0, 0].set(9), ctr=a.ctr.at[0, 0].set(1), vid=a.vid.at[0, 0].set(1))
    b = b._replace(cls=b.cls.at[0, 0].set(2), khi=b.khi.at[0, 0].set(5), ctr=b.ctr.at[0, 0].set(2), vid=b.vid.at[0, 0].set(2))
    merged, _ = merge_tables_xla(a, b, "lww")
    assert int(merged.vid[0, 0]) == 2  # later write wins despite smaller value
    merged_ref, _ = merge_tables_xla(a, b, "reference")
    assert int(merged_ref.vid[0, 0]) == 1  # value order wins in reference mode


def test_absent_loses_to_everything():
    a = init_table(1, 128)
    b = init_table(1, 128)
    b = b._replace(cls=b.cls.at[0, 0].set(1), vid=b.vid.at[0, 0].set(1))  # null
    merged, changed = merge_tables_xla(a, b, "reference")
    assert int(merged.cls[0, 0]) == 1 and int(changed) == 1


def test_lean_sim_converges_to_same_values():
    """lean_gossip=True must reach the same value state as the full path
    (metadata arrays may differ)."""
    import numpy as np

    from bullet_tpu.models.netsim import PeerNetworkSim

    def run(**kw):
        sim = PeerNetworkSim(8, capacity=128, topology="ring", **kw)
        rng = np.random.default_rng(11)
        for _ in range(50):
            sim.put(int(rng.integers(8)), f"k/v{int(rng.integers(10))}",
                    int(rng.integers(1000)))
        sim.run_until_converged()
        assert sim.tables_equal()
        return sim.get(0, "k")

    assert run() == run(lean_gossip=True)
