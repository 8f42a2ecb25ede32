"""Rank table layout: 8 B/entry — the packed layout's smaller, faster twin.

The packed layout (ops.packed.PackedTable) stores (khi, klo, cv) = 12 B/entry
and every merge compares the 4-key chain (cls, khi, klo, vid). But the merge
priority ONLY depends on the total order over (cls, khi, klo) triples — the
actual key bits never matter, just their relative order (reference resolver
/root/reference/src/bullet-crt.js:164-279 compares class precedence then
value order; quirk Q2's value-LWW). So a host-maintained 31-bit GAP RANK
over the distinct (cls, khi, klo) triples collapses the layout to TWO int32
arrays:

    rank, cv : int32 [P, N]     → 8 B/entry  (cv = cls << 28 | vid)

with the total order (rank, cv):

  * distinct triples get distinct ranks, strictly monotone in
    (cls, khi, klo) — rank comparison ≡ the 3-key prefix comparison;
  * equal ranks mean the SAME triple, hence the same cls, so the cv
    tiebreak is exactly the vid comparison — preserving the packed
    layout's vid-order quirk for equal-key values (e.g. false < 0 < true:
    distinct vids interning to one order key).

Absent entries are rank 0 / cv 0; real ranks are ≥ 1, so cls=0 padding can
never win a merge (the packed-family invariant). Converged states are
bit-identical to the packed layout modulo the khi/klo → rank projection
(tested by mapping results back through the vid).

All gossip/reconcile/window programs are SHARED with ops.packed — they
are layout-generic (keyed through packed.table_keys, which dispatches on
the field-tuple arity). This module adds what is genuinely rank-specific:
the layout type, the host rank maintenance (gap ranks with even-respread +
device re-key), the op pre-reduction, and the flat apply.

Against packed, a gossip round moves 16 B/entry instead of 24 and a
neighbor merge is a 1-key compare instead of 4. The north-star table
shrinks 12.9 GB → 8.6 GB.

Rank1Table goes one further: the rank alone, 4 B/entry (see its class
docstring) — cv decoding moves to the RankIndex inverse at read time.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .packed import (
    CV_SHIFT,
    VID_MASK,
    _flat_scatter,
    _flat_winners,
    merge_packed_xla,
)

RANK_SPAN = (1 << 31) - 1  # usable rank space: [1, 2^31 - 1]


class RankTable(NamedTuple):
    """Reference-mode replica tables at 8 B/entry (see module docstring).

    Field order matters: cv must be LAST (the shared programs' presence
    guard reads cls from ``fields[-1] >> 28``) and the tuple arity (2)
    selects the (rank, cv) key chain in packed.table_keys.
    """

    rank: jax.Array
    cv: jax.Array  # cls << 28 | vid


class Rank1Table(NamedTuple):
    """Reference-mode replica tables at 4 B/entry — the rank layout with
    the cv payload column dropped entirely.

    The rank is a BIJECTION over live entries (RankIndex gives every vid a
    distinct rank in (cls, khi, klo, vid) order), so the rank alone IS the
    entry: a merge is one int32 compare + one select, a gossip round moves
    8 B/entry of device memory instead of 16. Rank 0 = absent (live ranks
    ≥ 1), which doubles as the padding-never-wins invariant — no presence
    bits needed.

    What the 2-array layout kept cv for — decoding vid at read time —
    moves to an inverse lookup through the RankIndex: sorted live ranks ↔
    vids (``RankIndex.inverse_arrays``), a binary search per read. Reads
    and queries are rare next to merge rounds; the round is the north-star
    metric. Reference semantics unchanged: same converged states as the
    packed layout (bullet-crt.js:164-279), projected through the rank
    bijection.
    """

    rank: jax.Array


def init_rank(num_peers: int, capacity: int) -> RankTable:
    # two DISTINCT zero buffers (donation aliasing, as in init_packed)
    return RankTable(
        *(jnp.zeros((num_peers, capacity), dtype=jnp.int32) for _ in range(2))
    )


def init_rank1(num_peers: int, capacity: int) -> Rank1Table:
    return Rank1Table(jnp.zeros((num_peers, capacity), dtype=jnp.int32))


merge_rank_xla = merge_packed_xla  # layout-generic winner-select


# ------------------------------------------------------------ conversions


@functools.partial(jax.jit, donate_argnums=(0,))
def pack_to_rank(pt, rank_map: jax.Array) -> RankTable:
    """PackedTable → RankTable through the vid → rank LUT (absent rows
    stay 0). The packed buffers are DONATED — at north-star scale both
    layouts cannot coexist."""
    vid = pt.cv & VID_MASK
    present = (pt.cv >> CV_SHIFT) > 0
    return RankTable(
        rank=jnp.where(present, rank_map[vid], 0),
        cv=pt.cv,
    )


@jax.jit
def rank_to_packed(rt: RankTable, khi_map: jax.Array, klo_map: jax.Array):
    """RankTable → PackedTable through the vid → (khi, klo) LUTs (for
    interop/serialization/tests; cv carries cls+vid so it round-trips)."""
    from .packed import PackedTable

    vid = rt.cv & VID_MASK
    present = (rt.cv >> CV_SHIFT) > 0
    z = jnp.zeros_like(rt.cv)
    return PackedTable(
        khi=jnp.where(present, khi_map[vid], z),
        klo=jnp.where(present, klo_map[vid], z),
        cv=rt.cv,
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def rekey_rank(table: RankTable, rank_map: jax.Array) -> RankTable:
    """Refresh ranks from vid after a respread (the rank twin of netsim's
    _rekey_packed; cv is rank-independent so only one field re-gathers)."""
    vid = table.cv & VID_MASK
    present = (table.cv >> CV_SHIFT) > 0
    return RankTable(
        rank=jnp.where(present, rank_map[vid], table.rank),
        cv=table.cv,
    )


# ------------------------------------------------------- rank1 conversions


@jax.jit
def decode_vids_rank1(rank: jax.Array, sranks: jax.Array, svids: jax.Array):
    """(present, vid) for rank1 entries: binary-search each rank in the
    sorted live-rank array and read the matching vid. Ranks on device
    always come from the same RankIndex epoch as (sranks, svids) — but
    ``present`` additionally demands an EXACT hit, so an epoch-coherence
    regression (a stale rank that no longer exists in the inverse)
    surfaces as absence rather than decoding to a nearby wrong vid."""
    idx = jnp.clip(
        jnp.searchsorted(sranks, rank), 0, svids.shape[0] - 1
    )
    return (rank > 0) & (sranks[idx] == rank), svids[idx]


@functools.partial(jax.jit, donate_argnums=(0,))
def pack_to_rank1(pt, rank_map: jax.Array) -> Rank1Table:
    """PackedTable → Rank1Table through the vid → rank LUT (donates)."""
    vid = pt.cv & VID_MASK
    present = (pt.cv >> CV_SHIFT) > 0
    return Rank1Table(rank=jnp.where(present, rank_map[vid], 0))


@functools.partial(jax.jit, donate_argnums=(0,))
def rank_to_rank1(rt: RankTable) -> Rank1Table:
    return Rank1Table(rank=rt.rank)


@jax.jit
def rank1_to_rank(
    rt: Rank1Table, sranks: jax.Array, svids: jax.Array, cls_map: jax.Array
) -> RankTable:
    """Rank1Table → RankTable by rebuilding cv through the inverse LUT
    (for interop/serialization/tests)."""
    present, vid = decode_vids_rank1(rt.rank, sranks, svids)
    cv = jnp.where(
        present, (cls_map[vid] << CV_SHIFT) | vid, jnp.zeros_like(rt.rank)
    )
    return RankTable(rank=rt.rank, cv=cv)


@functools.partial(jax.jit, donate_argnums=(0,))
def rekey_rank1(
    table: Rank1Table,
    old_sranks: jax.Array,
    old_svids: jax.Array,
    rank_map: jax.Array,
) -> Rank1Table:
    """Re-gather a rank1 table onto a fresh rank epoch: decode each stale
    rank to its vid through the PRE-respread inverse (RankIndex snapshots
    it as ``prev_inverse`` when a respread fires), then gather the new
    rank. Donates the table (one field, updated in place)."""
    present, vid = decode_vids_rank1(table.rank, old_sranks, old_svids)
    return Rank1Table(
        rank=jnp.where(present, rank_map[vid], jnp.zeros_like(table.rank))
    )


# --------------------------------------------------------------- flat apply


def apply_flat_rank(
    table: RankTable,
    peer: jax.Array,
    slot: jax.Array,
    rank: jax.Array,
    cv: jax.Array,
) -> Tuple[RankTable, jax.Array]:
    """One-shot flat apply on the rank layout: K ops with UNIQUE (peer,
    slot) pairs SORTED by (peer, slot) — exactly what reduce_flat_ops_rank
    emits. Same two-program gather/scatter shape as apply_flat_packed (the
    fused form would copy the table; see that docstring). DONATES table."""
    new_vals, applied = _flat_winners(table, peer, slot, (rank, cv))
    table = _flat_scatter(table, peer, slot, new_vals)
    return table, applied


@jax.jit
def _unstack_ops4(ops):
    return ops[0], ops[1], ops[2], ops[3]


def apply_flat_rank_stacked(
    table: RankTable, ops: jax.Array
) -> Tuple[RankTable, jax.Array]:
    """apply_flat_rank over a stacked [4, K] op array (rows: peer, slot,
    rank, cv) — one host→device transfer, split on device."""
    peer, slot, rank, cv = _unstack_ops4(ops)
    return apply_flat_rank(table, peer, slot, rank, cv)


def apply_flat_rank1(
    table: Rank1Table, peer: jax.Array, slot: jax.Array, rank: jax.Array
) -> Tuple[Rank1Table, jax.Array]:
    """One-shot flat apply on the rank1 layout: the winner test is the
    single rank compare (op lands iff rank > current — rank 0 ops are
    guarded absent by packed.op_present). Ops must be unique-(peer, slot)
    sorted, as reduce_flat_ops_rank emits. DONATES table."""
    new_vals, applied = _flat_winners(table, peer, slot, (rank,))
    table = _flat_scatter(table, peer, slot, new_vals)
    return table, applied


@jax.jit
def _unstack_ops3(ops):
    return ops[0], ops[1], ops[2]


def apply_flat_rank1_stacked(
    table: Rank1Table, ops: jax.Array
) -> Tuple[Rank1Table, jax.Array]:
    """apply_flat_rank1 over a stacked [3, K] op array (rows: peer, slot,
    rank) — one host→device transfer, split on device."""
    peer, slot, rank = _unstack_ops3(ops)
    return apply_flat_rank1(table, peer, slot, rank)


def reduce_flat_ops_rank(peer, slot, rank, cv):
    """Host-side lattice pre-reduction on rank ops: keep the (rank, cv)-max
    op per (peer, slot), winners ascending by (peer, slot).

    The rank layout's win is visible here too: the winner key fuses into
    ONE int64 (rank·2^32 | cv — both fields are non-negative int32), so a
    single argsort + one maximum.reduceat replaces the packed path's two
    fused-key passes.

    The native radix+scan pass (native.reduce_flat_ops_rank) runs first
    when available; this numpy body is the bit-identical fallback
    (tested). Returns (peer, slot, rank, cv) winners or None if nothing
    survives."""
    from .. import native

    fast = native.reduce_flat_ops_rank(peer, slot, rank, cv, CV_SHIFT)
    if fast is not NotImplemented:
        return fast

    keep = (np.asarray(cv) >> CV_SHIFT) > 0
    peer, slot, rank, cv = (
        np.asarray(a)[keep] for a in (peer, slot, rank, cv)
    )
    if peer.size == 0:
        return None
    pslot = (peer.astype(np.int64) << 32) | slot.astype(np.int64)
    wkey = (rank.astype(np.int64) << 32) | cv.astype(np.int64)
    order = np.argsort(pslot)
    ps = pslot[order]
    first = np.empty(ps.size, dtype=bool)
    first[0] = True
    np.not_equal(ps[1:], ps[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    wmax = np.maximum.reduceat(wkey[order], starts)
    rank_w = (wmax >> 32).astype(np.int32)
    cv_w = (wmax & np.int64(0xFFFFFFFF)).astype(np.int32)
    keys = ps[starts]
    peer_w = (keys >> 32).astype(np.int32)
    slot_w = (keys & np.int64(0xFFFFFFFF)).astype(np.int32)
    return peer_w, slot_w, rank_w, cv_w


# ------------------------------------------------------ host rank index


class RankIndex:
    """Gap ranks over the distinct (cls, khi, klo) triples, indexed by vid.

    The host-side order authority for the rank layout: every interned vid
    gets a 31-bit rank strictly monotone in its (cls, khi, klo) key. New
    keys land in the gap between their sorted neighbors (a batch landing in
    one gap spreads evenly across it); when a gap is exhausted — or any
    stored key CHANGES order bits (string-rank rebalance) — the whole space
    respreads evenly and ``needs_rekey`` flags the device tables for a
    rank_map re-gather (netsim's _maybe_rekey twin).

    Keys are stored as two fused int64 columns (k1 = cls·2^32 | khi_u,
    k2 = klo_u — the bias-mapped uint halves recombine order-exactly, as in
    packed.reduce_flat_ops) so the lexicographic insert position falls out
    of a searchsorted on k1 refined by a searchsorted on k2 within the
    (rare) equal-k1 run.
    """

    _BIAS = np.int64(1) << 31

    def __init__(self) -> None:
        self._rank_of = np.zeros(0, dtype=np.int64)  # by vid
        self._svids = np.zeros(0, dtype=np.int64)  # vids sorted by key
        self._sranks = np.zeros(0, dtype=np.int64)  # ranks in svids order
        self._sk1 = np.zeros(0, dtype=np.int64)
        self._sk2 = np.zeros(0, dtype=np.int64)
        self.needs_rekey = False
        self.epoch = 0  # bumped on every respread
        self._inv_cache = None  # (sranks, svids), invalidated on insert
        self._scratch = [None, None]  # native merge pools (_merge_scratch)
        self._scratch_i = 0
        # (sorted ranks, vids) as of the moment the LAST respread fired —
        # the inverse the rank1 layout needs to decode a device table that
        # still holds the pre-respread ranks (see rekey_rank1). None until
        # the first respread over a non-empty index.
        self.prev_inverse: "tuple[np.ndarray, np.ndarray] | None" = None

    def __len__(self) -> int:
        return len(self._svids)

    def _fuse(self, cls, khi, klo):
        cls = np.asarray(cls, dtype=np.int64)
        khi = np.asarray(khi, dtype=np.int64)
        klo = np.asarray(klo, dtype=np.int64)
        return (cls << 32) | (khi + self._BIAS), klo + self._BIAS

    def rank_map(self, dtype=np.int32) -> np.ndarray:
        """vid → rank LUT for device conversion/re-keying."""
        return self._rank_of.astype(dtype)

    def rank_of(self, vid: int) -> int:
        return int(self._rank_of[vid])

    def _inverse(self):
        """Cached (sorted ranks int64, vids int64) — rebuilt only after an
        insert/respread (reads on the rank1 layout hit this per call)."""
        if self._inv_cache is None:
            # _sranks is maintained in merged order by every insert path —
            # no O(index) random gather through rank_of (which dominated
            # 1M-batch inserts at multi-million indexes on a 1-CPU host)
            self._inv_cache = (self._sranks, self._svids)
        return self._inv_cache

    def inverse_arrays(self, dtype=np.int32):
        """(sorted live ranks, matching vids) — the rank → vid inverse for
        the rank1 layout (binary-searchable; ranks are strictly increasing
        along the key-sorted vid order by construction)."""
        sranks, svids = self._inverse()
        return sranks.astype(dtype), svids.astype(dtype)

    def rank_bounds(self, cls, lo_khi, lo_klo, hi_khi, hi_klo):
        """(lo_rank, hi_rank) covering exactly the ranked vids whose
        (cls, khi, klo) key lies in the inclusive key interval — the rank1
        layout's range-query bounds (ranks are lexicographic in the keys,
        so the matching vids form ONE contiguous rank run). None if the
        interval holds no ranked vid. Bounds need not be interned."""
        k1lo, k2lo = self._fuse(cls, lo_khi, lo_klo)
        k1hi, k2hi = self._fuse(cls, hi_khi, hi_klo)
        # first stored key >= lo
        p = int(np.searchsorted(self._sk1, k1lo, side="left"))
        q = int(np.searchsorted(self._sk1, k1lo, side="right"))
        if p != q:  # refine within the equal-k1 run
            p += int(np.searchsorted(self._sk2[p:q], k2lo, side="left"))
        # last stored key <= hi (exclusive upper position)
        r = int(np.searchsorted(self._sk1, k1hi, side="left"))
        s = int(np.searchsorted(self._sk1, k1hi, side="right"))
        if r != s:
            r += int(np.searchsorted(self._sk2[r:s], k2hi, side="right"))
        else:
            r = s
        if p >= r:
            return None
        ranks, _ = self._inverse()
        return int(ranks[p]), int(ranks[r - 1])

    def decode_ranks(self, ranks: np.ndarray) -> np.ndarray:
        """Host-side rank → vid decode (current epoch). Rank 0 (absent)
        and any rank with no EXACT inverse entry decode to -1 — a stale
        rank must read as absent, never as a nearby wrong vid."""
        ranks = np.asarray(ranks, dtype=np.int64)
        if len(self._svids) == 0:
            return np.full(ranks.shape, -1, dtype=np.int64)
        sranks, svids = self._inverse()
        idx = np.searchsorted(sranks, ranks)
        idx = np.clip(idx, 0, len(svids) - 1)
        hit = (ranks > 0) & (sranks[idx] == ranks)
        return np.where(hit, svids[idx], -1)

    def _merge_scratch(self, need: int):
        """Alternating persistent output pools for the native sort-merge:
        the merged (k1, k2, svids, sranks) arrays this call produces BECOME the
        stored index (views into the pool), so the NEXT insert reads them
        as inputs — alternation guarantees inputs and outputs never
        alias. Reusing warm pages avoids the fresh-125-MB-per-call
        allocation churn that tripled insert wall time under memory
        pressure (docstring of native.rank_insert_batch). Holds at most
        2 × 4 × capacity × 8 B of host RAM, grown by doubling."""
        self._scratch_i ^= 1
        bufs = self._scratch[self._scratch_i]
        if bufs is None or len(bufs[0]) < need:
            # overallocate: growing indexes would otherwise outgrow the
            # pool on nearly every bulk insert and realloc anyway
            cap = max(2 * need, 2 * (len(bufs[0]) if bufs else 0))
            bufs = tuple(np.empty(cap, dtype=np.int64) for _ in range(4))
            self._scratch[self._scratch_i] = bufs
        return bufs

    def _respread(self) -> None:
        n = len(self._svids)
        gap = RANK_SPAN // (n + 1)
        ranks = (np.arange(1, n + 1, dtype=np.int64)) * gap
        self._rank_of[self._svids] = ranks
        self._sranks = ranks
        self._inv_cache = None
        self.needs_rekey = True
        self.epoch += 1

    def refresh_keys(self, cls_map, khi_map, klo_map) -> None:
        """Re-read every stored key from the interner's current tables
        (call after a string-rank rebalance: khi/klo bits moved, but the
        ORDER of existing vids is preserved by the rebalance contract, so
        the sorted vid sequence — and every rank — stays valid)."""
        k1, k2 = self._fuse(
            cls_map[self._svids], khi_map[self._svids], klo_map[self._svids]
        )
        self._sk1, self._sk2 = k1, k2

    def insert_batch(self, vids, cls, khi, klo) -> None:
        """Assign ranks to new vids with keys (cls, khi, klo). Vids must be
        NEW (never ranked) and HIGHER than every already-ranked vid (the
        interner assigns vids append-only, which guarantees it).

        Distinct vids CAN share one (cls, khi, klo) triple (e.g. false and
        0 intern to the same order key — the packed layout breaks that tie
        by vid). Rank order must therefore refine the triple order by vid:
        equal keys insert AFTER the existing equal-key run (searchsorted
        side='right'), and within a batch equal keys sort by vid — so
        rank order ≡ (cls, khi, klo, vid) order exactly, making the
        2-key (rank, cv) merge bit-identical to the packed 4-key chain
        (equal rank ⇒ same vid ⇒ same entry)."""
        vids = np.asarray(vids, dtype=np.int64)
        if vids.size == 0:
            return
        self._inv_cache = None
        need = int(vids.max()) + 1
        if need > len(self._rank_of):
            grown = np.zeros(max(need, 2 * len(self._rank_of)), dtype=np.int64)
            grown[: len(self._rank_of)] = self._rank_of
            self._rank_of = grown

        if len(self._svids) == 0:
            k1, k2 = self._fuse(cls, khi, klo)
            order = np.lexsort((vids, k2, k1))
            self._svids = vids[order]
            self._sk1, self._sk2 = k1[order], k2[order]
            self._respread()
            # a fresh table needs no device re-key (nothing on device yet
            # references these vids with other ranks) — but callers decide;
            # keep the flag cheap and honest
            self.needs_rekey = False
            return

        # pre-insert inverse snapshot: if this batch exhausts a gap and the
        # space respreads, a rank1 device table still holds THESE ranks —
        # rekey_rank1 decodes through them. NOTE old_ranks is a LIVE
        # reference to _sranks (not a copy): prev_inverse safety rests on
        # the .astype(np.int32) copies below and on no insert path
        # mutating _sranks in place (the pools only ever back NEW arrays)
        old_svids = self._svids
        old_ranks = self._sranks  # merged-order ranks: no O(index) gather

        from .. import native

        nat = None
        if native.load() is not None:
            # pools only exist when the native path will use them — a
            # fallback host would otherwise pin two dead 4-array pools
            # (~640 MB at a 4M index) the numpy chain never touches
            nat = native.rank_insert_batch(
                self._sk1, self._sk2, old_svids, old_ranks,
                cls, khi, klo, vids, self._BIAS, RANK_SPAN,
                out=self._merge_scratch(len(old_svids) + vids.size),
            )
        if nat is not None:
            # single-pass C++ sort-merge (key fuse inline), bit-identical
            # to the numpy chain below (fuzz-tested); ~5x at 1M batches
            m_k1, m_k2, m_svids, m_sranks, new_ranks, need_respread = nat
            self._sk1, self._sk2, self._svids = m_k1, m_k2, m_svids
            self._sranks = m_sranks
            self._rank_of[vids] = new_ranks
            if need_respread:
                self._respread()
                self.prev_inverse = (
                    old_ranks.astype(np.int32), old_svids.astype(np.int32)
                )
            return

        k1, k2 = self._fuse(cls, khi, klo)
        # insert position for each new key in the stored sorted order
        # (side='right' throughout: equal keys land after the existing run,
        # preserving vid order — see the docstring)
        left = np.searchsorted(self._sk1, k1, side="left")
        pos = np.searchsorted(self._sk1, k1, side="right")
        collide = left != pos
        if np.any(collide):
            # vectorized within-run refinement (a per-key Python loop here
            # cost ~10 s per 1M-op apply at the north-star shape: float
            # values share k1 high words, so most keys collide). Encode
            # each stored element as run_id·2^32 + k2 — run_id is the
            # index of its equal-k1 run, k2 ∈ [0, 2^32) — which is
            # globally sorted, so ONE searchsorted over the encoding
            # yields the absolute refined position: elements of earlier
            # runs all encode smaller, same-run elements order by k2.
            # run_id ≤ len(svids) ≤ 2^28 (MAX_VID) keeps the fuse in
            # int64.
            m = len(self._sk1)
            new_run = np.empty(m, dtype=bool)
            new_run[0] = True
            np.not_equal(self._sk1[1:], self._sk1[:-1], out=new_run[1:])
            run_id = np.cumsum(new_run, dtype=np.int64) - 1
            enc_stored = (run_id << 32) | self._sk2
            qrun = run_id[left[collide]]
            enc_q = (qrun << 32) | k2[collide]
            pos[collide] = np.searchsorted(enc_stored, enc_q, side="right")
        # order new items by (position, key, vid) so same-gap items stack
        order = np.lexsort((vids, k2, k1, pos))
        pos, k1, k2, vids = pos[order], k1[order], k2[order], vids[order]

        # neighbor ranks around each insertion gap
        ranks_sorted = self._sranks
        lo_rank = np.where(pos > 0, ranks_sorted[np.maximum(pos - 1, 0)], 0)
        hi_rank = np.where(
            pos < len(ranks_sorted),
            ranks_sorted[np.minimum(pos, len(ranks_sorted) - 1)],
            RANK_SPAN,
        )
        # per-gap even spread: i-th of g items in gap (lo, hi) gets
        # lo + (hi-lo)*(i+1)/(g+1)
        first = np.empty(pos.size, dtype=bool)
        first[0] = True
        np.not_equal(pos[1:], pos[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        sizes = np.diff(np.append(starts, pos.size))
        within = np.arange(pos.size, dtype=np.int64) - np.repeat(starts, sizes)
        g = np.repeat(sizes, sizes).astype(np.int64)
        new_ranks = lo_rank + (hi_rank - lo_rank) * (within + 1) // (g + 1)

        # merge into the sorted arrays
        self._svids = np.insert(self._svids, pos, vids)
        self._sk1 = np.insert(self._sk1, pos, k1)
        self._sk2 = np.insert(self._sk2, pos, k2)
        self._sranks = np.insert(self._sranks, pos, new_ranks)
        self._rank_of[vids] = new_ranks

        # any collision with a neighbor rank ⇒ the gap was exhausted
        all_ranks = self._sranks
        if np.any(all_ranks[1:] <= all_ranks[:-1]) or all_ranks[0] < 1:
            self._respread()
            self.prev_inverse = (
                old_ranks.astype(np.int32), old_svids.astype(np.int32)
            )
