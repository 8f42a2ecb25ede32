"""Gossip rounds: topology-shaped neighbor exchange + semilattice merge.

The engine's replacement for the reference's async TTL flood
(/root/reference/src/bullet-network.js:378-418) and chunked anti-entropy
sync (bullet-network-sync.js): one synchronous round delivers every peer the
merge of its neighbors' tables. Because the merge is a join-semilattice
(DESIGN.md), rounds reach the reference's fixed point in ≤ diameter rounds,
deterministically.

Fast paths lower to collective-friendly ops (``jnp.roll`` on a sharded peer
axis becomes a collective-permute under pjit; recursive doubling is the
classic all-reduce shape). The generic path gathers by a neighbor-index
matrix — XLA turns the cross-shard gathers into collectives.

``lean`` rounds (reference mode) exchange only the four value-key arrays
(cls, khi, klo, vid): writer/ctr/tick keep their locally written values,
matching the reference's receive-side metadata reset (meta.source becomes
"network", bullet.js:198-203).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.merge import TableState, merge_tables_xla, priority_keys, lex_gt
from .topology import Topology


def _roll(table: TableState, shift: int) -> TableState:
    return TableState(*(jnp.roll(f, shift, axis=0) for f in table))


def _mask_rows(table: TableState, valid: jax.Array) -> TableState:
    """Invalidate rows (make them ABSENT so they lose every merge)."""
    valid = valid[:, None]
    return TableState(*(jnp.where(valid, f, jnp.zeros_like(f)) for f in table))


def _merge(
    a: TableState, b: TableState, mode: str, lean: bool = False
) -> Tuple[TableState, jax.Array]:
    if not lean:
        return merge_tables_xla(a, b, mode)
    keys = lambda t: (t.cls, t.khi, t.klo, t.vid)
    take_b = lex_gt(keys(b), keys(a))
    merged = a._replace(
        **{f: jnp.where(take_b, getattr(b, f), getattr(a, f))
           for f in ("cls", "khi", "klo", "vid")}
    )
    return merged, jnp.sum(take_b.astype(jnp.int32))


def gossip_round_ring(
    table: TableState, mode: str, lean: bool = False
) -> Tuple[TableState, jax.Array]:
    """Ring: receive from both neighbors (each peer has 2, matching the
    circle example's wiring)."""
    m1, c1 = _merge(table, _roll(table, 1), mode, lean)
    m2, c2 = _merge(m1, _roll(table, -1), mode, lean)
    return m2, c1 + c2


def gossip_round_chain(
    table: TableState, mode: str, lean: bool = False
) -> Tuple[TableState, jax.Array]:
    """Chain: ring shifts with the wrap-around rows masked out."""
    num_peers = table.cls.shape[0]
    rows = jnp.arange(num_peers)
    from_left = _mask_rows(_roll(table, 1), rows >= 1)
    from_right = _mask_rows(_roll(table, -1), rows < num_peers - 1)
    m1, c1 = _merge(table, from_left, mode, lean)
    m2, c2 = _merge(m1, from_right, mode, lean)
    return m2, c1 + c2


def gossip_round_mesh(
    table: TableState, mode: str, lean: bool = False
) -> Tuple[TableState, jax.Array]:
    """Full mesh: one round makes everyone equal. Recursive doubling —
    ceil(log2 P) shifted merges; idempotence makes the overlap harmless.
    fori_loop over the doubling steps for the same compile-time reason as
    ``gossip_round_generic``."""
    num_peers = table.cls.shape[0]
    steps = max(1, (num_peers - 1).bit_length())

    def body(k, carry):
        tbl, total = carry
        shift = jnp.left_shift(jnp.int32(1), k)
        rolled = TableState(*(jnp.roll(f, shift, axis=0) for f in tbl))
        tbl, c = _merge(tbl, rolled, mode, lean)
        return tbl, total + c

    table, total = jax.lax.fori_loop(0, steps, body, (table, jnp.int32(0)))
    return table, total


def gossip_round_generic(
    table: TableState, neighbors: jax.Array, mode: str, lean: bool = False
) -> Tuple[TableState, jax.Array]:
    """Arbitrary adjacency: gather each neighbor column and merge.

    ``neighbors`` is [P, max_deg] int32 with -1 padding; padded entries are
    masked to ABSENT and cannot win. The column loop is a ``fori_loop`` —
    unrolling chained gather+merge makes XLA:CPU compile time grow
    exponentially in the degree (measured ~3.3×/iteration).
    """

    def body(k, carry):
        tbl, total = carry
        idx = jax.lax.dynamic_index_in_dim(neighbors, k, axis=1, keepdims=False)
        valid = idx >= 0
        safe = jnp.where(valid, idx, 0)
        gathered = TableState(*(f[safe] for f in tbl))
        gathered = _mask_rows(gathered, valid)
        tbl, c = _merge(tbl, gathered, mode, lean)
        return tbl, total + c

    table, total = jax.lax.fori_loop(
        0, neighbors.shape[1], body, (table, jnp.int32(0))
    )
    return table, total


@functools.partial(jax.jit, static_argnames=("kind", "mode", "lean"))
def _gossip_round_jit(table, neighbors, kind: str, mode: str, lean: bool):
    if kind == "ring":
        return gossip_round_ring(table, mode, lean)
    if kind == "chain":
        return gossip_round_chain(table, mode, lean)
    if kind == "mesh":
        return gossip_round_mesh(table, mode, lean)
    return gossip_round_generic(table, neighbors, mode, lean)


def gossip_round(
    table: TableState,
    topology: Topology,
    mode: str = "reference",
    mesh=None,
    lean: bool = False,
) -> Tuple[TableState, jax.Array]:
    """One synchronous gossip round; returns (table, changed_count).

    With a mesh provided, EVERY topology has an explicit shard_map SPMD
    path (ppermute boundary rows for ring/chain, recursive-doubling
    ppermute for mesh, lattice all-reduce for star, masked all_gather for
    generic adjacencies); otherwise the XLA path (collectives inferred by
    XLA when the table is sharded)."""
    if mesh is not None:
        from .shardmap_gossip import shardmap_round

        return shardmap_round(table, topology, mesh, mode=mode)
    neighbors = jnp.asarray(topology.neighbors)
    return _gossip_round_jit(table, neighbors, topology.kind, mode, lean)


@functools.partial(
    jax.jit,
    static_argnames=(
        "kind", "mode", "max_rounds", "lean", "spmd_mesh", "topo_name", "hub",
    ),
)
def gossip_until_converged_device(
    table: TableState,
    neighbors: jax.Array,
    kind: str,
    mode: str,
    max_rounds: int,
    lean: bool = False,
    spmd_mesh=None,
    topo_name: str = "",
    hub: int = 0,
) -> Tuple[TableState, jax.Array]:
    """Run rounds on-device until the residual hits zero (bounded by
    ``max_rounds``) — no host round-trips, one compiled while_loop. With
    ``spmd_mesh`` the body is the explicit shard_map collective round."""

    def round_fn(tbl):
        if spmd_mesh is not None:
            from .shardmap_gossip import (
                generic_round_shardmap,
                mesh_round_shardmap,
                ring_round_shardmap,
                star_round_shardmap,
            )

            if kind in ("ring", "chain"):
                return ring_round_shardmap(
                    tbl, spmd_mesh, mode=mode, wrap=kind == "ring"
                )
            if kind == "mesh":
                return mesh_round_shardmap(tbl, spmd_mesh, mode=mode)
            if topo_name == "star":
                return star_round_shardmap(tbl, spmd_mesh, mode=mode, hub=hub)
            return generic_round_shardmap(tbl, neighbors, spmd_mesh, mode=mode)
        return _gossip_round_jit(tbl, neighbors, kind, mode, lean)

    def cond(state):
        _, rounds, last_changed = state
        return (rounds < max_rounds) & (last_changed > 0)

    def body(state):
        tbl, rounds, _ = state
        tbl, changed = round_fn(tbl)
        return tbl, rounds + 1, changed

    table, rounds, last_changed = jax.lax.while_loop(
        cond, body, (table, jnp.int32(0), jnp.int32(1))
    )
    # last_changed == 0 iff the fixed point was reached (vs the round cap);
    # the initial sentinel 1 only survives when max_rounds == 0
    return table, rounds, last_changed
