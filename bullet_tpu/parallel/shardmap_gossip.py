"""Explicit SPMD gossip: shard_map + ppermute/all_gather over the device mesh.

The jit+sharding path (parallel.gossip) lets XLA infer collectives from
``jnp.roll``/gathers on the sharded peer axis. This module is the explicit
alternative — per-shard local compute plus hand-placed collectives — the
pattern SURVEY §2 names as the NCCL-equivalent slot:

* ring/chain — ``ppermute`` of exactly the boundary rows (one peer row per
  direction per device; minimal collective payload by construction). The
  window variant exchanges m rows once per m rounds (``fast_forward``).
* full mesh — recursive doubling: log2(P) rounds of global-roll-by-2^k,
  each roll at most two block ``ppermute``s (whole-block hop + remainder
  splice). Bit-identical to ``gossip_round_mesh`` including change counts.
* star — lattice all-reduce for the hub (local row-reduce → ``all_gather``
  of one row per device → device reduce) + one-row hub broadcast for the
  spokes. O(N·D) collective traffic instead of gathering P rows.
* generic (bridge, partitions, random graphs) — masked ``all_gather``: the
  full table is gathered per neighbor column and merged under the adjacency
  mask, reproducing ``gossip_round_generic`` bit-identically (including its
  within-round propagation through already-merged rows). Traffic is O(N·P)
  per device — intended for the moderate peer counts these irregular
  topologies model (the reference bridge example is 11 peers).

Results are bit-identical to the unsharded rounds (tested on the virtual
CPU mesh); star's change count is the strict-improvement count against the
pre-round hub (zero iff the unsharded count is zero).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.merge import TableState, merge_tables_xla
from .mesh import PEER_AXIS

_lexmax = merge_tables_xla  # per-shard local merge is exactly the XLA merge


def _ring_exchange(ctor, merge, wrap: bool, block):
    """Shared ring/chain block body for any table tuple type: local shifts
    plus ppermute'd boundary rows, two lattice merges, psum'd change count.

    Chain masking note: zeroing from_prev on the globally-first device (and
    from_next on the last) is sufficient — those rows ARE the up/down
    neighbors of the global edge rows, so no second intra-block mask is
    needed (up[0] is from_prev by construction)."""
    axis_size = jax.lax.axis_size(PEER_AXIS)
    idx = jax.lax.axis_index(PEER_AXIS)
    fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]

    def boundary(rows, perm):
        return ctor(*(jax.lax.ppermute(f, PEER_AXIS, perm) for f in rows))

    from_prev = boundary(ctor(*(f[-1:, :] for f in block)), fwd)
    from_next = boundary(ctor(*(f[:1, :] for f in block)), bwd)

    if not wrap:
        # chain: the global edge devices must not receive wrapped rows
        is_first = idx == 0
        is_last = idx == axis_size - 1
        from_prev = ctor(
            *(jnp.where(is_first, jnp.zeros_like(f), f) for f in from_prev)
        )
        from_next = ctor(
            *(jnp.where(is_last, jnp.zeros_like(f), f) for f in from_next)
        )

    up = ctor(
        *(
            jnp.concatenate([fp, f[:-1, :]], axis=0)
            for f, fp in zip(block, from_prev)
        )
    )
    down = ctor(
        *(
            jnp.concatenate([f[1:, :], fn], axis=0)
            for f, fn in zip(block, from_next)
        )
    )
    m1, c1 = merge(block, up)
    m2, c2 = merge(m1, down)
    changed = jax.lax.psum(c1 + c2, PEER_AXIS)
    return (*m2, changed)


def _ring_block(mode: str, wrap: bool, *fields):
    """Per-shard body: local shifts + ppermute'd boundary rows."""
    return _ring_exchange(
        TableState, lambda a, b: _lexmax(a, b, mode), wrap, TableState(*fields)
    )


@functools.partial(jax.jit, static_argnames=("mesh", "mode", "wrap"))
def ring_round_shardmap(
    table: TableState, mesh, mode: str = "reference", wrap: bool = True
) -> Tuple[TableState, jax.Array]:
    """One ring (wrap=True) / chain (wrap=False) round, explicitly SPMD."""
    fn = jax.shard_map(
        functools.partial(_ring_block, mode, wrap),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(7)),
        out_specs=(*[P(PEER_AXIS, None)] * 7, P()),
    )
    *fields, changed = fn(*table)
    return TableState(*fields), changed


# ---------------------------------------------------------------- full mesh


def _global_roll(block, s: int, axis_size: int, b: int, ctor=TableState):
    """Global ``jnp.roll(·, s, axis=0)`` over the sharded peer axis: rows hop
    ``s // b`` whole devices by ppermute, the ``s % b`` remainder splices the
    boundary between two permuted blocks."""
    s %= axis_size * b
    d, r = divmod(s, b)

    def permute(tbl, hops: int):
        if hops % axis_size == 0:
            return tbl
        perm = [(i, (i + hops) % axis_size) for i in range(axis_size)]
        return ctor(
            *(jax.lax.ppermute(f, PEER_AXIS, perm) for f in tbl)
        )

    from_d = permute(block, d)
    if r == 0:
        return from_d
    from_d1 = permute(block, d + 1)
    return ctor(
        *(
            jnp.concatenate([f1[b - r :], f0[: b - r]], axis=0)
            for f0, f1 in zip(from_d, from_d1)
        )
    )


def _mesh_exchange(ctor, merge, steps: int, axis_size: int, block):
    """Recursive doubling (matches gossip_round_mesh exactly): merge with the
    current table rolled by 2^k, k = 0..steps-1. The loop is a static unroll
    because each step's ppermute permutation differs (log2(P) steps)."""
    b = block[0].shape[0]
    total = jnp.int32(0)
    for k in range(steps):
        rolled = _global_roll(block, 1 << k, axis_size, b, ctor)
        block, c = merge(block, rolled)
        total = total + c
    return (*block, jax.lax.psum(total, PEER_AXIS))


def _mesh_block(mode: str, steps: int, axis_size: int, *fields):
    return _mesh_exchange(
        TableState, lambda a, b: _lexmax(a, b, mode), steps, axis_size,
        TableState(*fields),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "mode"))
def mesh_round_shardmap(
    table: TableState, mesh, mode: str = "reference"
) -> Tuple[TableState, jax.Array]:
    """One full-mesh round, explicitly SPMD (bit-identical to the unsharded
    ``gossip_round_mesh``, change counts included)."""
    num_peers = table.cls.shape[0]
    steps = max(1, (num_peers - 1).bit_length())
    fn = jax.shard_map(
        functools.partial(_mesh_block, mode, steps, mesh.devices.size),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(7)),
        out_specs=(*[P(PEER_AXIS, None)] * 7, P()),
    )
    *fields, changed = fn(*table)
    return TableState(*fields), changed


# --------------------------------------------------------------------- star


def _star_exchange(ctor, merge, hub_dev: int, hub_row: int, block):
    """Hub = lattice max of all rows (local reduce → all_gather of one row
    per device → device reduce); spokes merge the hub's PRE-round row."""
    b = block[0].shape[0]
    idx = jax.lax.axis_index(PEER_AXIS)
    on_hub_dev = idx == hub_dev

    # hub's pre-round row: every device contributes its local hub_row
    # candidate; the all_gather stack is indexed at the owning device
    cand = ctor(*(f[hub_row : hub_row + 1] for f in block))
    stack = ctor(
        *(
            jax.lax.all_gather(f, PEER_AXIS, axis=0, tiled=True)
            for f in cand
        )
    )  # [D, N]
    hub_old = ctor(*(f[hub_dev : hub_dev + 1] for f in stack))

    # spokes merge hub_old (the hub row merging itself is an idempotent
    # no-op contributing zero to the change count)
    bcast = ctor(
        *(jnp.broadcast_to(f, (b, f.shape[1])) for f in hub_old)
    )
    merged, c_spokes = merge(block, bcast)

    # hub's new row: lattice max over ALL peer rows (includes hub itself)
    def row_reduce(k, acc):
        row = ctor(*(jax.lax.dynamic_slice_in_dim(f, k, 1) for f in block))
        m, _ = merge(acc, row)
        return m

    local_max = ctor(*(f[0:1] for f in block))
    local_max = jax.lax.fori_loop(1, b, row_reduce, local_max)
    gstack = ctor(
        *(
            jax.lax.all_gather(f, PEER_AXIS, axis=0, tiled=True)
            for f in local_max
        )
    )  # [D, N]

    def dev_reduce(k, acc):
        row = ctor(*(jax.lax.dynamic_slice_in_dim(f, k, 1) for f in gstack))
        m, _ = merge(acc, row)
        return m

    gmax = ctor(*(f[0:1] for f in gstack))
    gmax = jax.lax.fori_loop(1, gstack[0].shape[0], dev_reduce, gmax)
    new_hub, c_hub = merge(hub_old, gmax)

    rows = jnp.arange(b)[:, None]
    sel = on_hub_dev & (rows == hub_row)
    out = ctor(
        *(
            jnp.where(sel, jnp.broadcast_to(nh, f.shape), f)
            for f, nh in zip(merged, new_hub)
        )
    )
    changed = jax.lax.psum(
        c_spokes + jnp.where(on_hub_dev, c_hub, 0), PEER_AXIS
    )
    return (*out, changed)


def _star_block(mode: str, hub_dev: int, hub_row: int, *fields):
    return _star_exchange(
        TableState, lambda a, b: _lexmax(a, b, mode), hub_dev, hub_row,
        TableState(*fields),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "mode", "hub"))
def star_round_shardmap(
    table: TableState, mesh, mode: str = "reference", hub: int = 0
) -> Tuple[TableState, jax.Array]:
    """One star round, explicitly SPMD. Converged values are identical to the
    unsharded generic round (lattice max is merge-order-free); the change
    count is the strict-improvement count vs the pre-round hub (zero iff the
    unsharded count is zero)."""
    b = table.cls.shape[0] // mesh.devices.size
    hub_dev, hub_row = divmod(hub, b)
    fn = jax.shard_map(
        functools.partial(_star_block, mode, hub_dev, hub_row),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(7)),
        out_specs=(*[P(PEER_AXIS, None)] * 7, P()),
    )
    *fields, changed = fn(*table)
    return TableState(*fields), changed


# ---------------------------------------------------- generic (masked AG)


def _generic_exchange(ctor, merge, neighbors, block):
    """Masked all_gather: per neighbor column, gather the CURRENT full table
    (so within-round propagation through already-merged rows matches
    ``gossip_round_generic`` bit-exactly) and merge under the adjacency
    mask. Padded (-1) neighbors are masked to ABSENT and cannot win."""
    b = block[0].shape[0]
    idx = jax.lax.axis_index(PEER_AXIS)
    my_rows = idx * b + jnp.arange(b)
    my_nbrs = neighbors[my_rows]  # [b, max_deg]

    def body(k, carry):
        blk, total = carry
        full = ctor(
            *(
                jax.lax.all_gather(f, PEER_AXIS, axis=0, tiled=True)
                for f in blk
            )
        )  # [P, N]
        col = jax.lax.dynamic_index_in_dim(my_nbrs, k, axis=1, keepdims=False)
        valid = (col >= 0)[:, None]
        safe = jnp.where(col >= 0, col, 0)
        gathered = ctor(
            *(jnp.where(valid, f[safe], jnp.zeros_like(f[safe])) for f in full)
        )
        blk, c = merge(blk, gathered)
        return blk, total + c

    # the count carry must enter the loop already device-varying, or the
    # carry types mismatch once a varying c is added (shard_map typing)
    zero = jax.lax.pcast(jnp.int32(0), PEER_AXIS, to="varying")
    block, total = jax.lax.fori_loop(0, my_nbrs.shape[1], body, (block, zero))
    return (*block, jax.lax.psum(total, PEER_AXIS))


def _generic_block(mode: str, *args):
    neighbors, fields = args[0], args[1:]
    return _generic_exchange(
        TableState, lambda a, b: _lexmax(a, b, mode), neighbors,
        TableState(*fields),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "mode"))
def generic_round_shardmap(
    table: TableState, neighbors: jax.Array, mesh, mode: str = "reference"
) -> Tuple[TableState, jax.Array]:
    """One round over an arbitrary adjacency (bridge, partitioned, random),
    explicitly SPMD; bit-identical to ``gossip_round_generic`` including
    change counts. O(N·P) gather traffic per device — for the moderate P
    these irregular topologies model."""
    fn = jax.shard_map(
        functools.partial(_generic_block, mode),
        mesh=mesh,
        in_specs=(P(), *[P(PEER_AXIS, None)] * 7),
        out_specs=(*[P(PEER_AXIS, None)] * 7, P()),
    )
    *fields, changed = fn(neighbors, *table)
    return TableState(*fields), changed


# ------------------------------------------------------------------ packed


def _ring_block_packed(tcls, wrap: bool, *fields):
    """Packed-family ring/chain block: the shared exchange body over the
    layout's field tuple (packed 3-array or rank 2-array)."""
    from ..ops.packed import merge_packed_xla

    return _ring_exchange(
        tcls, merge_packed_xla, wrap, tcls(*fields)
    )


@functools.partial(jax.jit, static_argnames=("mesh", "wrap"))
def ring_round_shardmap_packed(table, mesh, wrap: bool = True):
    """One explicit-SPMD ring/chain round on the packed family — boundary
    traffic is 12 B/entry/row (packed), 8 (rank) or 4 (rank1), vs 28 for
    dense."""
    nf, tcls = len(table), type(table)
    fn = jax.shard_map(
        functools.partial(_ring_block_packed, tcls, wrap),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(nf)),
        out_specs=(*[P(PEER_AXIS, None)] * nf, P()),
    )
    *fields, changed = fn(*table)
    return tcls(*fields), changed


def _window_block_packed(tcls, wrap: bool, m: int, *fields):
    """Per-device window-join body: ONE m-row boundary exchange buys m
    ring/chain rounds. Each device ppermutes its m edge rows per direction
    (the same total boundary bytes as m single rounds, but ONE collective
    latency instead of m), extends its local block to [m + local_p + m]
    rows, and computes the radius-m window join in O(log m) 3-way joins
    (the merge is an idempotent lattice join, so m Jacobi rounds ≡ one
    radius-m window — ops/packed.ring_window_packed_xla's proof). Ext-edge
    shifts zero-fill: rows within r of the ext edge are invalid at radius
    r, and the trapezoid argument (valid(q, r+s) needs valid(q±s, r))
    keeps every CENTER row exact because the halo is exactly m deep; on
    the global chain edges the zero-masked halos are not garbage but the
    exact identity the classic chain round uses. The final round runs
    classically so the psum'd count is the exact classic round-m residual
    over center rows. Requires m ≤ local rows (the slab comes from ONE
    neighbor)."""
    from ..ops.packed import _lex_gt_packed, _window_chain, table_keys

    axis_size = jax.lax.axis_size(PEER_AXIS)
    idx = jax.lax.axis_index(PEER_AXIS)
    fwd = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    bwd = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    block = list(fields)
    local_p = block[0].shape[0]

    from_prev = [
        jax.lax.ppermute(f[-m:, :], PEER_AXIS, fwd) for f in block
    ]
    from_next = [jax.lax.ppermute(f[:m, :], PEER_AXIS, bwd) for f in block]
    if not wrap:
        is_first = idx == 0
        is_last = idx == axis_size - 1
        from_prev = [
            jnp.where(is_first, jnp.zeros_like(f), f) for f in from_prev
        ]
        from_next = [
            jnp.where(is_last, jnp.zeros_like(f), f) for f in from_next
        ]
    ext = [
        jnp.concatenate([fp, f, fn], axis=0)
        for fp, f, fn in zip(from_prev, block, from_next)
    ]

    ext_p = local_p + 2 * m
    row = jax.lax.broadcasted_iota(jnp.int32, ext[0].shape, 0)

    def shifted(vs, s: int):
        out = []
        for f in vs:
            rolled = jnp.roll(f, s, axis=0)
            edge = row < s if s > 0 else row >= ext_p + s
            out.append(jnp.where(edge, 0, rolled))
        return out

    def lexmax(a_vals, b_vals):
        gt = _lex_gt_packed(
            table_keys(tuple(b_vals)), table_keys(tuple(a_vals))
        )
        return [jnp.where(gt, b, a) for a, b in zip(a_vals, b_vals)], gt

    vals = ext
    for s in _window_chain(m - 1):
        vals, _ = lexmax(vals, shifted(vals, +s))
        vals, _ = lexmax(vals, shifted(vals, -s))
    m1, gt1 = lexmax(vals, shifted(vals, +1))
    m2, gt2 = lexmax(m1, shifted(m1, -1))
    center = (row >= m) & (row < m + local_p)
    c = jnp.sum((gt1 & center).astype(jnp.int32)) + jnp.sum(
        (gt2 & center).astype(jnp.int32)
    )
    changed = jax.lax.psum(c, PEER_AXIS)
    return (*(v[m : m + local_p, :] for v in m2), changed)


@functools.partial(jax.jit, static_argnames=("mesh", "wrap", "m"))
def ring_window_shardmap_packed(table, mesh, wrap: bool, m: int):
    """m explicit-SPMD ring/chain rounds per ONE boundary collective
    round-trip: the multi-device twin of ops/packed.ring_window_packed_xla
    — bit-identical state to m classic rounds, exact classic round-m
    residual (psum over devices). m must not exceed the per-device row
    count; the sim's fast_forward caps its passes accordingly."""
    nf, tcls = len(table), type(table)
    assert m <= table[0].shape[0] // mesh.devices.size, (
        "window depth exceeds per-device rows"
    )
    fn = jax.shard_map(
        functools.partial(_window_block_packed, tcls, wrap, m),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(nf)),
        out_specs=(*[P(PEER_AXIS, None)] * nf, P()),
    )
    *fields, changed = fn(*table)
    return tcls(*fields), changed


def _mesh_block_packed(tcls, steps: int, axis_size: int, *fields):
    from ..ops.packed import merge_packed_xla

    return _mesh_exchange(
        tcls, merge_packed_xla, steps, axis_size, tcls(*fields)
    )


@functools.partial(jax.jit, static_argnames=("mesh",))
def mesh_round_shardmap_packed(table, mesh):
    """One full-mesh round on the packed layout, explicitly SPMD
    (recursive-doubling ppermute; bit-identical to the unsharded packed
    mesh round, change counts included)."""
    nf, tcls = len(table), type(table)
    num_peers = table[0].shape[0]
    steps = max(1, (num_peers - 1).bit_length())
    fn = jax.shard_map(
        functools.partial(_mesh_block_packed, tcls, steps, mesh.devices.size),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(nf)),
        out_specs=(*[P(PEER_AXIS, None)] * nf, P()),
    )
    *fields, changed = fn(*table)
    return tcls(*fields), changed


@functools.partial(jax.jit, static_argnames=("mesh",), donate_argnums=(0,))
def reconcile_shardmap_packed(table, mesh):
    """Direct reconcile of a strongly connected topology on the mesh: the
    ceil(log2 P) doubling join is exactly one full-mesh round, run here on
    a donated table (ops/packed.reconcile_packed_xla's sharded twin)."""
    return mesh_round_shardmap_packed(table, mesh)[0]


def _star_block_packed(tcls, hub_dev: int, hub_row: int, *fields):
    from ..ops.packed import merge_packed_xla

    return _star_exchange(
        tcls, merge_packed_xla, hub_dev, hub_row, tcls(*fields)
    )


@functools.partial(jax.jit, static_argnames=("mesh", "hub"))
def star_round_shardmap_packed(table, mesh, hub: int = 0):
    """One star round on the packed layout (lattice all-reduce hub + one-row
    hub broadcast), explicitly SPMD; same change-count convention as the
    dense star collective."""
    nf, tcls = len(table), type(table)
    b = table[0].shape[0] // mesh.devices.size
    hub_dev, hub_row = divmod(hub, b)
    fn = jax.shard_map(
        functools.partial(_star_block_packed, tcls, hub_dev, hub_row),
        mesh=mesh,
        in_specs=tuple(P(PEER_AXIS, None) for _ in range(nf)),
        out_specs=(*[P(PEER_AXIS, None)] * nf, P()),
    )
    *fields, changed = fn(*table)
    return tcls(*fields), changed


def _generic_block_packed(tcls, *args):
    from ..ops.packed import merge_packed_xla

    neighbors, fields = args[0], args[1:]
    return _generic_exchange(
        tcls, merge_packed_xla, neighbors, tcls(*fields)
    )


@functools.partial(jax.jit, static_argnames=("mesh",))
def generic_round_shardmap_packed(table, neighbors: jax.Array, mesh):
    """One round over an arbitrary adjacency on the packed layout (masked
    all_gather); bit-identical to the unsharded generic packed round."""
    nf, tcls = len(table), type(table)
    fn = jax.shard_map(
        functools.partial(_generic_block_packed, tcls),
        mesh=mesh,
        in_specs=(P(), *[P(PEER_AXIS, None)] * nf),
        out_specs=(*[P(PEER_AXIS, None)] * nf, P()),
    )
    *fields, changed = fn(neighbors, *table)
    return tcls(*fields), changed


def shardmap_round_packed(table, topology, mesh):
    """Dispatch one explicit-SPMD round for any topology on the packed
    layout — the packed twin of ``shardmap_round`` (ppermute ring/chain,
    recursive-doubling mesh, lattice+hub star, masked all_gather
    otherwise)."""
    import numpy as np

    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap_packed(
            table, mesh, wrap=topology.kind == "ring"
        )
    if topology.kind == "mesh":
        return mesh_round_shardmap_packed(table, mesh)
    if topology.name == "star":
        hub = int(np.argmax(topology.degree()))
        return star_round_shardmap_packed(table, mesh, hub=hub)
    return generic_round_shardmap_packed(
        table, jnp.asarray(topology.neighbors), mesh
    )


def shardmap_round(
    table: TableState, topology, mesh, mode: str = "reference"
) -> Tuple[TableState, jax.Array]:
    """Dispatch one explicit-SPMD round for any topology (SURVEY §2:
    ppermute for ring/chain, recursive-doubling ppermute for mesh, lattice
    all-reduce for star, masked all_gather otherwise)."""
    import numpy as np

    if topology.kind in ("ring", "chain"):
        return ring_round_shardmap(
            table, mesh, mode=mode, wrap=topology.kind == "ring"
        )
    if topology.kind == "mesh":
        return mesh_round_shardmap(table, mesh, mode=mode)
    if topology.name == "star":
        hub = int(np.argmax(topology.degree()))
        return star_round_shardmap(table, mesh, mode=mode, hub=hub)
    return generic_round_shardmap(
        table, jnp.asarray(topology.neighbors), mesh, mode=mode
    )
