"""Packed ultra-lean table layout: 12 B/entry, the north-star shape enabler.

The dense layout (ops.merge.TableState) spends 28 B/entry; reference-mode
merge priority only ever reads the four value keys (cls, khi, klo, vid) —
writer/ctr/tick are local bookkeeping the reference discards on receive
(meta.source, /root/reference/src/bullet.js:198-203). Packing cls (3 bits)
and vid (≤ 2^28) into one word ``cv = cls << 28 | vid`` yields a 3-array
layout:

    khi, klo, cv : int32 [P, N]   → 12 B/entry

1,024 peers × 1M slots ≈ 12.9 GB. The merge order is unchanged:
lexicographic over ``(cv >> 28, khi, klo, cv)`` ≡ (cls, khi, klo, vid),
because equal cls makes the final cv comparison a vid comparison. Converged
states are bit-identical to dense reference mode (tested);
``applied``/``changed`` counts exclude metadata-only updates (a dense-mode
op that ties on all four value keys but wins on writer/ctr updates
bookkeeping without changing the value).

Every program here is plain XLA and layout-generic over the packed family
(packed, rank, rank1 — see ``table_keys``): gossip rounds, the compiled
convergence loop, the doubling reconcile and the radius-m window join that
``fast_forward`` rides.
"""


from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .apply import OpBatch
from .merge import TableState, lex_gt

CV_SHIFT = 28
VID_MASK = (1 << CV_SHIFT) - 1
MAX_VID = VID_MASK  # interner capacity in packed mode: 2^28 distinct values


class PackedTable(NamedTuple):
    """Reference-mode replica tables at 12 B/entry (see module docstring)."""

    khi: jax.Array
    klo: jax.Array
    cv: jax.Array  # cls << 28 | vid


def init_packed(num_peers: int, capacity: int) -> PackedTable:
    # three DISTINCT zero buffers: apply donates the table, and donating one
    # aliased buffer three times is an error
    return PackedTable(
        *(jnp.zeros((num_peers, capacity), dtype=jnp.int32) for _ in range(3))
    )


def pack_cv(cls, vid):
    return (cls << CV_SHIFT) | vid


def pack_table(t: TableState) -> PackedTable:
    """Dense → packed (drops writer/ctr/tick)."""
    return PackedTable(t.khi, t.klo, pack_cv(t.cls, t.vid))


def unpack_table(pt: PackedTable) -> TableState:
    """Packed → dense with zeroed metadata (for interop/serialization)."""
    z = jnp.zeros_like(pt.cv)
    return TableState(
        cls=pt.cv >> CV_SHIFT,
        khi=pt.khi,
        klo=pt.klo,
        vid=pt.cv & VID_MASK,
        writer=z,
        ctr=z,
        tick=z,
    )


def packed_keys(khi, klo, cv):
    """(cls, khi, klo, vid) as a 4-key lex chain on packed fields."""
    return (cv >> CV_SHIFT, khi, klo, cv)


def _lex_gt_packed(b_keys, a_keys):
    """b strictly beats a under the packed key chain. Thin delegation to
    ops.merge.lex_gt — NOTE the argument order: the first argument is the
    CHALLENGER (kept this way because every packed call site asks "does b
    beat a?")."""
    return lex_gt(b_keys, a_keys)


def table_keys(fields):
    """Lex key chain for a packed-FAMILY field tuple, dispatched on length:
    3 fields = the packed layout (khi, klo, cv) → (cls, khi, klo, vid);
    2 fields = the rank layout (rank, cv) → ONE key, the rank;
    1 field = the rank1 layout (rank alone) → the same single key. The
    RankIndex assigns distinct vids distinct ranks in (cls, khi, klo, vid)
    order (a bijection refining the packed chain — see ops.rank), so equal
    ranks mean the SAME vid, hence the same cv: the cv tiebreak can never
    fire, and a single int32 compare decides every merge. Every shared
    merge keys through this, making the programs here layout-generic."""
    if len(fields) <= 2:
        return (fields[0],)
    return packed_keys(*fields)


def op_present(vals):
    """Live-op guard for a packed-family op/entry field tuple. Arity 1 is
    the rank1 layout: the single field IS the rank, and rank 0 = absent
    (live ranks are ≥ 1 by RankIndex construction). Otherwise the last
    field is cv, whose top bits carry cls (cls 0 = absent)."""
    if len(vals) == 1:
        return vals[0] > 0
    return (vals[-1] >> CV_SHIFT) > 0


def merge_packed_xla(
    a: PackedTable, b: PackedTable
) -> Tuple[PackedTable, jax.Array]:
    """Reference-mode winner-select over packed-family tables + changed
    count (layout-generic: works on PackedTable and ops.rank.RankTable)."""
    take_b = _lex_gt_packed(
        table_keys(tuple(b)), table_keys(tuple(a))
    )
    merged = type(a)(*(jnp.where(take_b, fb, fa) for fa, fb in zip(a, b)))
    return merged, jnp.sum(take_b.astype(jnp.int32))


# ---------------------------------------------------------------- op apply


@functools.partial(jax.jit, donate_argnums=(0,))
def apply_ops_packed(
    table: PackedTable, ops: OpBatch, tick: jax.Array
) -> Tuple[PackedTable, jax.Array]:
    """Reference-mode op application on the packed layout.

    An op lands iff its value keys strictly beat the current entry
    (quirk Q2's value-LWW); metadata-only wins (vid tie, higher writer/ctr)
    are value no-ops in dense mode and simply don't exist here.

    The table buffer is DONATED (no second scan-carry copy). Callers must
    not reuse their input reference (netsim reassigns ``self.table``).
    """
    num_peers = table.khi.shape[0]
    rows = jnp.arange(num_peers, dtype=jnp.int32)

    def body(carry, op_col):
        tbl, applied = carry
        slot, ocls, okhi, oklo, ovid, _octr = op_col
        cur = tuple(f[rows, slot] for f in tbl)  # (khi, klo, cv) [P]
        ocv = pack_cv(ocls, ovid)
        win = _lex_gt_packed(
            packed_keys(okhi, oklo, ocv), packed_keys(*cur)
        ) & (ocls > 0)
        new_vals = (
            jnp.where(win, okhi, cur[0]),
            jnp.where(win, oklo, cur[1]),
            jnp.where(win, ocv, cur[2]),
        )
        tbl = PackedTable(
            *(f.at[rows, slot].set(v) for f, v in zip(tbl, new_vals))
        )
        return (tbl, applied + jnp.sum(win.astype(jnp.int32))), None

    cols = tuple(jnp.moveaxis(f, 1, 0) for f in ops)
    (table, applied), _ = jax.lax.scan(body, (table, jnp.int32(0)), cols)
    return table, applied


@jax.jit
def _flat_winners(table, peer, slot, vals):
    """Read-only pass: gather current entries, decide winners, emit the [K]
    update values (loser slots re-emit their current value). ``vals`` is
    the op field tuple matching the table layout (last field is always cv,
    whose top bits carry cls — the presence guard)."""
    cur = tuple(f[peer, slot] for f in table)
    win = _lex_gt_packed(
        table_keys(vals), table_keys(cur)
    ) & op_present(vals)
    return (
        tuple(jnp.where(win, v, c) for v, c in zip(vals, cur)),
        jnp.sum(win.astype(jnp.int32)),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_one(arr, peer, slot, values):
    """Scatter into ONE donated array in place."""
    return arr.at[peer, slot].set(
        values, unique_indices=True, indices_are_sorted=True
    )


def _flat_scatter(table, peer, slot, new_vals):
    return type(table)(
        *(
            _scatter_one(f, peer, slot, v)
            for f, v in zip(table, new_vals)
        )
    )


def apply_flat_packed(
    table: PackedTable,
    peer: jax.Array,
    slot: jax.Array,
    khi: jax.Array,
    klo: jax.Array,
    cv: jax.Array,
) -> Tuple[PackedTable, jax.Array]:
    """One-shot flat apply: K ops with UNIQUE (peer, slot) pairs SORTED by
    (peer, slot) — exactly what ``reduce_flat_ops`` emits; the full-table
    scatter path asserts both properties to XLA. The pre-reduction keeps
    each pair's lattice winner (order-free, so the outcome matches
    sequential application). Gather+compare and scatter run as two
    programs: fused, XLA would copy the table (the scatter output aliases a
    buffer the gather still reads). The table buffer is DONATED."""
    new_vals, applied = _flat_winners(table, peer, slot, (khi, klo, cv))
    table = _flat_scatter(table, peer, slot, new_vals)
    return table, applied


@jax.jit
def _unstack_ops(ops):
    return ops[0], ops[1], ops[2], ops[3], ops[4]


def apply_flat_packed_stacked(
    table: PackedTable, ops: jax.Array
) -> Tuple[PackedTable, jax.Array]:
    """apply_flat_packed over a stacked [5, K] op array (rows: peer, slot,
    khi, klo, cv). Callers ship the whole reduced batch as ONE host→device
    transfer and the rows split on device."""
    peer, slot, khi, klo, cv = _unstack_ops(ops)
    return apply_flat_packed(table, peer, slot, khi, klo, cv)



def reduce_flat_ops(peer, slot, cls, khi, klo, vid):
    """Host-side lattice pre-reduction: keep the (cls, khi, klo, vid)-max op
    per (peer, slot), winners ascending by (peer, slot) — the order the
    flat scatter asserts to XLA.

    One single-key argsort groups rows by a fused (peer, slot) int64; the
    per-group lex-max then falls out of two segmented ``maximum.reduceat``
    passes over fused comparison keys — k1 = cls·2³² + khi_u (35 bits,
    priority (cls, khi)) and k2 = klo_u·2²⁸ + vid (60 bits, priority
    (klo, vid)); the bias-mapped uint halves recombine order-exactly
    (utils.encode.number_key). The winner's fields decode straight from
    (k1, k2max) — no row indirection.

    The native radix+scan pass (native/__init__.py::reduce_flat_ops) runs
    first when available; this numpy body is the bit-identical fallback
    (tested)."""
    import numpy as np

    from .. import native

    fast = native.reduce_flat_ops(
        peer, slot, cls, khi, klo, vid, CV_SHIFT, VID_MASK
    )
    if fast is not NotImplemented:
        return fast

    keep = cls > 0
    peer, slot, cls, khi, klo, vid = (
        a[keep] for a in (peer, slot, cls, khi, klo, vid)
    )
    if peer.size == 0:
        return None
    bias = np.int64(1) << 31
    pslot = (peer.astype(np.int64) << 32) | slot.astype(np.int64)
    k1 = (cls.astype(np.int64) << 32) | (khi.astype(np.int64) + bias)
    k2 = ((klo.astype(np.int64) + bias) << CV_SHIFT) | vid.astype(np.int64)
    order = np.argsort(pslot)  # winner needs no row identity: any sort kind
    ps = pslot[order]
    first = np.empty(ps.size, dtype=bool)
    first[0] = True
    np.not_equal(ps[1:], ps[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    k1s = k1[order]
    m1 = np.maximum.reduceat(k1s, starts)
    sizes = np.diff(np.concatenate((starts, [ps.size])))
    m1_rows = np.repeat(m1, sizes)
    k2s = np.where(k1s == m1_rows, k2[order], np.int64(-1))
    m2 = np.maximum.reduceat(k2s, starts)
    cls_w = m1 >> 32
    khi_w = ((m1 & np.int64(0xFFFFFFFF)) - bias).astype(np.int32)
    klo_w = ((m2 >> CV_SHIFT) - bias).astype(np.int32)
    cv = ((cls_w << CV_SHIFT) | (m2 & np.int64(VID_MASK))).astype(np.int32)
    keys = ps[starts]
    peer_w = (keys >> 32).astype(np.int32)
    slot_w = (keys & np.int64(0xFFFFFFFF)).astype(np.int32)
    return peer_w, slot_w, khi_w, klo_w, cv


# ------------------------------------------------------------ gossip (XLA)


def _mask_rows(table: PackedTable, valid: jax.Array) -> PackedTable:
    valid = valid[:, None]
    return type(table)(
        *(jnp.where(valid, f, jnp.zeros_like(f)) for f in table)
    )


def gossip_round_ring_packed(table: PackedTable) -> Tuple[PackedTable, jax.Array]:
    roll = lambda s: type(table)(*(jnp.roll(f, s, axis=0) for f in table))
    m1, c1 = merge_packed_xla(table, roll(1))
    m2, c2 = merge_packed_xla(m1, roll(-1))
    return m2, c1 + c2


def gossip_round_chain_packed(table: PackedTable) -> Tuple[PackedTable, jax.Array]:
    num_peers = table[0].shape[0]
    rows = jnp.arange(num_peers)
    roll = lambda s: type(table)(*(jnp.roll(f, s, axis=0) for f in table))
    m1, c1 = merge_packed_xla(table, _mask_rows(roll(1), rows >= 1))
    m2, c2 = merge_packed_xla(m1, _mask_rows(roll(-1), rows < num_peers - 1))
    return m2, c1 + c2


def gossip_round_mesh_packed(table: PackedTable) -> Tuple[PackedTable, jax.Array]:
    num_peers = table[0].shape[0]
    steps = max(1, (num_peers - 1).bit_length())

    def body(k, carry):
        tbl, total = carry
        shift = jnp.left_shift(jnp.int32(1), k)
        rolled = type(tbl)(*(jnp.roll(f, shift, axis=0) for f in tbl))
        tbl, c = merge_packed_xla(tbl, rolled)
        return tbl, total + c

    return jax.lax.fori_loop(0, steps, body, (table, jnp.int32(0)))


def gossip_round_generic_packed(
    table: PackedTable, neighbors: jax.Array
) -> Tuple[PackedTable, jax.Array]:
    def body(k, carry):
        tbl, total = carry
        idx = jax.lax.dynamic_index_in_dim(neighbors, k, axis=1, keepdims=False)
        valid = idx >= 0
        safe = jnp.where(valid, idx, 0)
        gathered = _mask_rows(type(tbl)(*(f[safe] for f in tbl)), valid)
        tbl, c = merge_packed_xla(tbl, gathered)
        return tbl, total + c

    return jax.lax.fori_loop(
        0, neighbors.shape[1], body, (table, jnp.int32(0))
    )


@functools.partial(jax.jit, static_argnames=("kind",))
def _gossip_round_packed_jit(table, neighbors, kind: str):
    if kind == "ring":
        return gossip_round_ring_packed(table)
    if kind == "chain":
        return gossip_round_chain_packed(table)
    if kind == "mesh":
        return gossip_round_mesh_packed(table)
    return gossip_round_generic_packed(table, neighbors)


def _window_chain(m: int):
    """Static shift schedule whose 3-way joins grow the window radius to
    exactly ``m`` in O(log m) steps: from radius r, joining the window with
    copies of itself shifted by ±s covers radius r+s contiguously for any
    s ≤ 2r+1 (the three arcs overlap or touch, and the join is idempotent,
    so overlap is free) — greedy s = min(m-r, 2r+1) lands on m exactly."""
    steps = []
    r = 0
    while r < m:
        s = min(m - r, 2 * r + 1)
        steps.append(s)
        r += s
    return steps


@functools.partial(
    jax.jit, static_argnames=("wrap", "m"), donate_argnums=(0,)
)
def ring_window_packed_xla(
    table: PackedTable, wrap: bool, m: int
) -> Tuple[PackedTable, jax.Array]:
    """m ring/chain rounds as one radius-m window join.

    One classic round is the radius-1 window join (row p absorbs rows
    p±1), and the merge is an idempotent/commutative/associative lattice
    join, so m Jacobi rounds ≡ the radius-m window join — computable in
    O(log m) roll+join passes (``_window_chain``) instead of m. The
    schedule reaches radius m-1, then the FINAL round runs the classic
    round body, so the returned count is the classic round-m residual.

    Chain edges (wrap=False): shifted copies CLAMP to the edge row's
    accumulated window rather than zero-fill — rows within s of the edge
    still owe the window the edge-clipped coverage their out-of-range
    shift would have carried. The clamped rows are a subset of the true
    window, so idempotence keeps the join exact. Bit-identical to m
    sequential gossip_round_{ring,chain}_packed calls (tested)."""
    p = table[0].shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, table[0].shape, 0)

    def shifted(vals, s: int):
        out = []
        for f in vals:
            rolled = jnp.roll(f, s, axis=0)
            if not wrap:
                if s > 0:
                    rolled = jnp.where(row < s, f[0:1, :], rolled)
                else:
                    rolled = jnp.where(row >= p + s, f[p - 1 :, :], rolled)
            out.append(rolled)
        return out

    def lexmax(a_vals, b_vals):
        gt = _lex_gt_packed(
            table_keys(tuple(b_vals)), table_keys(tuple(a_vals))
        )
        return [jnp.where(gt, b, a) for a, b in zip(a_vals, b_vals)]

    vals = list(table)
    for s in _window_chain(m - 1):
        vals = lexmax(vals, shifted(vals, +s))
        vals = lexmax(vals, shifted(vals, -s))
    t = type(table)(*vals)
    return (gossip_round_ring_packed if wrap else gossip_round_chain_packed)(t)


@functools.partial(jax.jit, donate_argnums=(0,))
def reconcile_packed_xla(table: PackedTable) -> PackedTable:
    """Direct reconcile of a strongly connected topology: ceil(log2 P)
    roll-and-merge doubling passes leave every row holding the join of all
    P rows (row i absorbs row i-2^k each pass). On a sharded table the
    rolls lower to collective permutes."""
    p = table[0].shape[0]

    def body(k, tbl):
        shift = jnp.left_shift(jnp.int32(1), k)
        rolled = type(tbl)(*(jnp.roll(f, shift, axis=0) for f in tbl))
        tbl, _ = merge_packed_xla(tbl, rolled)
        return tbl

    steps = max(1, (p - 1).bit_length())
    return jax.lax.fori_loop(0, steps, body, table)


@functools.partial(jax.jit, static_argnames=("wrap",))
def count_changes_round_packed(table, wrap: bool) -> jax.Array:
    """Entries one ring (wrap) / chain round would change, without
    advancing state: the round's count is its only output, so XLA fuses
    the merges into the reduction and writes nothing table-sized."""
    round_fn = gossip_round_ring_packed if wrap else gossip_round_chain_packed
    return round_fn(table)[1]


# ----------------------------------------------------------- convergence


def gossip_round_packed(
    table: PackedTable, topology, mesh=None
) -> Tuple[PackedTable, jax.Array]:
    """One packed round for any topology (explicit shard_map collectives
    on a mesh, XLA otherwise)."""
    if mesh is not None:
        from ..parallel.shardmap_gossip import shardmap_round_packed

        return shardmap_round_packed(table, topology, mesh)
    return _gossip_round_packed_jit(
        table, jnp.asarray(topology.neighbors), topology.kind
    )


@functools.partial(
    jax.jit,
    static_argnames=("kind", "max_rounds", "spmd_mesh", "topo_name", "hub"),
    donate_argnums=(0,),
)
def gossip_until_converged_packed(
    table: PackedTable,
    neighbors: jax.Array,
    kind: str,
    max_rounds: int,
    spmd_mesh=None,
    topo_name: str = "",
    hub: int = 0,
) -> Tuple[PackedTable, jax.Array]:
    """Packed convergence loop: compiled while_loop, donated carry. With
    ``spmd_mesh`` the body is the explicit shard_map collective for the
    topology family (ppermute ring/chain, recursive-doubling mesh,
    lattice+hub star when ``topo_name`` says so, masked all_gather
    otherwise) — the packed twin of the dense dispatch."""

    def round_fn(tbl):
        if spmd_mesh is not None:
            from ..parallel import shardmap_gossip as smg

            if kind in ("ring", "chain"):
                return smg.ring_round_shardmap_packed(
                    tbl, spmd_mesh, wrap=kind == "ring"
                )
            if kind == "mesh":
                return smg.mesh_round_shardmap_packed(tbl, spmd_mesh)
            if topo_name == "star":
                return smg.star_round_shardmap_packed(
                    tbl, spmd_mesh, hub=hub
                )
            return smg.generic_round_shardmap_packed(
                tbl, neighbors, spmd_mesh
            )
        return _gossip_round_packed_jit(tbl, neighbors, kind)

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
    return table, rounds, last_changed
