"""The CRT merge: a lexicographic-max select over encoded tables.

This is the engine's replacement for the reference's ``resolve`` hot loop
(/root/reference/src/bullet-crt.js:164-279). Per DESIGN.md, the reference's
converged semantics reduce to a join-semilattice, so merging two replica
tables is a pure elementwise winner-select under a total order:

* ``mode="reference"`` — priority ``(cls, khi, klo, vid, writer, ctr)``:
  comparator value-max, matching the reference's converged states.
* ``mode="lww"``      — priority ``(ctr, cls, khi, klo, vid, writer)``:
  Lamport last-writer-wins (the documented fix of quirk Q2).

Both are associative/commutative/idempotent ⇒ gossip order cannot change the
fixed point. The merge is an int32 compare-and-select with a fused
changed-entry count (the convergence residual); XLA fuses both into one
memory-bound pass.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

FIELDS = ("cls", "khi", "klo", "vid", "writer", "ctr", "tick")


class TableState(NamedTuple):
    """One replica table per simulated peer: all arrays are int32 [P, N].

    ``cls/khi/klo/vid`` encode the leaf value (bullet_tpu.utils.encode);
    ``writer`` is the peer id of the winning write, ``ctr`` its Lamport
    counter, ``tick`` the sim step of last modification (the engine's
    ``meta.lastModified``, /root/reference/src/bullet.js:198-203).
    """

    cls: jax.Array
    khi: jax.Array
    klo: jax.Array
    vid: jax.Array
    writer: jax.Array
    ctr: jax.Array
    tick: jax.Array


def init_table(num_peers: int, capacity: int) -> TableState:
    """All-absent table (cls=0 loses to every real value)."""
    z = jnp.zeros((num_peers, capacity), dtype=jnp.int32)
    return TableState(z, z, z, z, z, z, z)


def priority_keys(t: TableState, mode: str) -> Tuple[jax.Array, ...]:
    if mode == "reference":
        return (t.cls, t.khi, t.klo, t.vid, t.writer, t.ctr)
    if mode == "lww":
        return (t.ctr, t.cls, t.khi, t.klo, t.vid, t.writer)
    raise ValueError(f"unknown merge mode: {mode}")


def lex_gt(a_keys: Sequence[jax.Array], b_keys: Sequence[jax.Array]) -> jax.Array:
    """Elementwise ``a > b`` under lexicographic order of the key chain."""
    gt = jnp.zeros_like(a_keys[0], dtype=jnp.bool_)
    eq = jnp.ones_like(a_keys[0], dtype=jnp.bool_)
    for a, b in zip(a_keys, b_keys):
        gt = gt | (eq & (a > b))
        eq = eq & (a == b)
    return gt


def merge_tables_xla(
    a: TableState, b: TableState, mode: str = "reference"
) -> Tuple[TableState, jax.Array]:
    """Winner-select + changed count.

    ``changed`` counts entries where ``b`` strictly beat ``a`` — exactly the
    entries a real peer would have applied (``doUpdate``), and the gossip
    convergence residual.
    """
    take_b = lex_gt(priority_keys(b, mode), priority_keys(a, mode))
    merged = TableState(*(jnp.where(take_b, fb, fa) for fa, fb in zip(a, b)))
    return merged, jnp.sum(take_b.astype(jnp.int32))
