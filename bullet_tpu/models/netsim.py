"""PeerNetworkSim — the engine: P replicated peers, one graph table each,
jit-compiled step loop.

This is the engine described by BASELINE.json's north star: the reference's
whole distributed system (bullet.js write path -> CRT resolve -> network
flood -> anti-entropy sync, SURVEY §3.2-3.4) becomes

    step = apply op batch  ->  CRT merge  ->  gossip round(s) over topology

entirely on device. The API mirrors the reference surface per peer:
``put/get/on/remove``, ``equals/range/filter/count/map/find``, snapshots.

Convergence is deterministic: the merge is a join-semilattice, so
``run_until_converged`` reaches the unique fixed point in ≤ diameter rounds
(a compiled ``while_loop``, zero host round-trips).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.apply import OpBatch, apply_ops
from ..ops.merge import TableState, init_table
from ..ops import scans
from ..parallel import topology as topo
from ..parallel.gossip import gossip_round, gossip_until_converged_device
from ..parallel.mesh import make_mesh, pad_peers_to_mesh, peer_sharding, shard_table
from ..utils.encode import CLS_ABSENT, VID_NULL
from .table import MISSING, GraphHost, flatten_value

TopologyLike = Union[str, topo.Topology]

# the layouts that share the packed-family programs (ops/packed.py key
# chains dispatched on field-tuple arity: 3 = packed, 2 = rank, 1 = rank1)
PACKED_FAMILY = ("packed", "rank", "rank1")
# the layouts whose merge order rides a host-maintained RankIndex
RANK_FAMILY = ("rank", "rank1")


class ConvergenceCell(NamedTuple):
    """The dispatch-relevant shape of a convergence request. Built by
    ``PeerNetworkSim._convergence_cell``; consumed by the strategy table."""

    layout: str  # "packed" | "rank" | "rank1" | "dense"


# Convergence strategy table: (name, predicate, runner method name) —
# FIRST match wins. ``run_until_converged`` resolves the cell, picks the
# row, and calls the runner; the cell-coverage test enumerates every cell
# and asserts the chosen row. Both runners are compiled whole-table
# while_loops; under a shard_map mesh their round body is the explicit
# collective for the topology. Runners own their loop + stats bookkeeping
# and return the executed round count.
CONVERGENCE_STRATEGIES: Tuple[Tuple[str, Callable, str], ...] = (
    (
        "packed-loop",  # packed-family whole-table while_loop
        lambda c: c.layout in PACKED_FAMILY,
        "_converge_packed_loop",
    ),
    (
        "dense-loop",  # dense whole-table while_loop (any topology)
        lambda c: True,
        "_converge_dense_loop",
    ),
)


def _group_positions(peers: np.ndarray, num_peers: int):
    """Within-batch sequence position of each op among its peer's ops, plus
    per-peer counts (stable order). Shared by put_bulk and _drain_ops so the
    Lamport stamps and dense batch positions can never diverge. The native
    single counting pass replaces the argsort chain (~0.37 s → ~5 ms at 1M
    ops); the numpy fallback is bit-identical (tested)."""
    from .. import native

    fast = native.group_positions(peers, num_peers)
    if fast is not None:
        return fast
    k = len(peers)
    counts = np.bincount(peers, minlength=num_peers)
    order = np.argsort(peers, kind="stable")
    sorted_peers = peers[order]
    boundaries = np.flatnonzero(np.diff(sorted_peers)) + 1
    starts = np.concatenate(([0], boundaries))
    group_sizes = np.diff(np.concatenate((starts, [k])))
    seq_sorted = np.arange(k) - np.repeat(starts, group_sizes)
    seq = np.empty(k, dtype=np.int64)
    seq[order] = seq_sorted
    return seq, counts



def _resolve_topology(t: TopologyLike, num_peers: int) -> topo.Topology:
    if isinstance(t, topo.Topology):
        return t
    builders = {
        "ring": topo.ring,
        "chain": topo.chain,
        "mesh": topo.full_mesh,
        "full_mesh": topo.full_mesh,
        "star": topo.star,
    }
    if t == "bridge":
        # the reference bridge example: 2 clusters × 5 + 1 bridge node
        if num_peers < 3:
            raise ValueError("bridge topology needs at least 3 peers")
        built = topo.bridge()
        if built.num_peers != num_peers:
            per = max(1, (num_peers - 1) // 2)
            built = topo.bridge((per, num_peers - 1 - per), 1)
        return built
    if t not in builders:
        raise ValueError(f"unknown topology: {t}")
    return builders[t](num_peers)


@jax.jit
def _gather_entries(table: TableState, peer, slots):
    return tuple(f[peer, slots] for f in table)


@jax.jit
def _gather_entries_packed(table, peer, slots):
    from ..ops.packed import CV_SHIFT, VID_MASK

    cv = table.cv[peer, slots]
    return cv >> CV_SHIFT, cv & VID_MASK


@jax.jit
def _gather_pairs(table: TableState, peers, slots):
    return table.cls[peers, slots], table.vid[peers, slots]


@jax.jit
def _gather_pairs_packed(table, peers, slots):
    from ..ops.packed import CV_SHIFT, VID_MASK

    cv = table.cv[peers, slots]
    return cv >> CV_SHIFT, cv & VID_MASK


@jax.jit
def _rekey(table: TableState, cls_map, khi_map, klo_map):
    """Refresh (cls, khi, klo) from vid after a string-rank rebalance."""
    return table._replace(
        cls=jnp.where(table.cls > 0, cls_map[table.vid], table.cls),
        khi=jnp.where(table.cls > 0, khi_map[table.vid], table.khi),
        klo=jnp.where(table.cls > 0, klo_map[table.vid], table.klo),
    )


@jax.jit
def _rekey_packed(table, cls_map, khi_map, klo_map):
    from ..ops.packed import CV_SHIFT, VID_MASK, PackedTable, pack_cv

    vid = table.cv & VID_MASK
    present = (table.cv >> CV_SHIFT) > 0
    return PackedTable(
        khi=jnp.where(present, khi_map[vid], table.khi),
        klo=jnp.where(present, klo_map[vid], table.klo),
        cv=jnp.where(present, pack_cv(cls_map[vid], vid), table.cv),
    )


@functools.partial(
    jax.jit, static_argnames=("mode", "lean"), donate_argnums=(0,)
)
def _reconcile_dense_jit(table: TableState, mode: str, lean: bool):
    """Dense direct reconcile: one full-mesh doubling round (which by
    construction joins every peer's entries and broadcasts the result).
    Lean sims join the four value-key arrays only — writer/ctr/tick stay
    local, exactly the lean gossip contract."""
    from ..parallel.gossip import gossip_round_mesh

    if not lean:
        return gossip_round_mesh(table, mode)
    from ..ops.merge import lex_gt

    p = table.cls.shape[0]
    steps = max(1, (p - 1).bit_length())

    def body(k, vals):
        shift = jnp.left_shift(jnp.int32(1), k)
        rolled = tuple(jnp.roll(f, shift, axis=0) for f in vals)
        gt = lex_gt(rolled, vals)
        return tuple(jnp.where(gt, b, a) for a, b in zip(vals, rolled))

    cls, khi, klo, vid = jax.lax.fori_loop(
        0, steps, body, (table.cls, table.khi, table.klo, table.vid)
    )
    return table._replace(cls=cls, khi=khi, klo=klo, vid=vid), jnp.int32(0)


def _doubling_join_rows(rows, merge_one):
    """Join a [K, N] row block to one row via roll-doubling: after
    ceil(log2 K) steps every row holds the join of all K (row i absorbs
    row i-2^k each step), so row 0 is the answer. K may be padded with
    duplicate rows — the join is idempotent, so padding is free."""
    k = rows[0].shape[0]
    steps = (k - 1).bit_length()

    def body(s, vals):
        shift = jnp.left_shift(jnp.int32(1), s)
        rolled = tuple(jnp.roll(f, shift, axis=0) for f in vals)
        return merge_one(vals, rolled)

    joined = jax.lax.fori_loop(0, steps, body, tuple(rows))
    return tuple(f[0] for f in joined)


@functools.partial(
    jax.jit, static_argnames=("mode", "lean"), donate_argnums=(0,)
)
def _closure_join_dense(
    table: TableState, idx, members, mode: str, lean: bool
) -> TableState:
    """Join rows ``table[idx]`` under ``mode``'s priority order and write
    the result to rows ``members`` — one step of the per-SCC reconcile DP
    (see PeerNetworkSim._reconcile_weak). ``idx``/``members`` are padded
    to powers of two with duplicate entries (bounds jit variants to
    log2(P)^2) — duplicates are free: the join is idempotent and scatter
    duplicates write identical rows. Lean sims join the four value-key
    arrays only; writer/ctr/tick stay local (the lean gossip contract)."""
    from ..ops.merge import lex_gt, priority_keys

    if lean:
        fields = (table.cls, table.khi, table.klo, table.vid)

        def merge_lean(a, b):
            gt = lex_gt(b, a)
            return tuple(jnp.where(gt, fb, fa) for fa, fb in zip(a, b))

        cls, khi, klo, vid = _doubling_join_rows(
            tuple(f[idx] for f in fields), merge_lean
        )
        return table._replace(
            cls=table.cls.at[members].set(cls),
            khi=table.khi.at[members].set(khi),
            klo=table.klo.at[members].set(klo),
            vid=table.vid.at[members].set(vid),
        )

    def merge_full(a, b):
        ta, tb = TableState(*a), TableState(*b)
        gt = lex_gt(priority_keys(tb, mode), priority_keys(ta, mode))
        return tuple(jnp.where(gt, fb, fa) for fa, fb in zip(a, b))

    row = _doubling_join_rows(tuple(f[idx] for f in table), merge_full)
    return TableState(
        *(f.at[members].set(r) for f, r in zip(table, row))
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _closure_join_packed(table, idx, members):
    """Packed-family twin of _closure_join_dense (reference mode only —
    the packed key chain (cls, khi, klo, vid) ≡ the rank chain (rank, cv)
    is the merge order; layout-generic via merge_packed_xla)."""
    from ..ops.packed import merge_packed_xla

    tcls = type(table)

    def merge_one(a, b):
        merged, _ = merge_packed_xla(tcls(*a), tcls(*b))
        return tuple(merged)

    row = _doubling_join_rows(tuple(f[idx] for f in table), merge_one)
    return tcls(
        *(f.at[members].set(r) for f, r in zip(table, row))
    )


@jax.jit
def _gather_watch_dense(table, peers, slots):
    return table.cls[peers, slots], table.vid[peers, slots]


@jax.jit
def _gather_watch_packed(table, peers, slots):
    return table.cv[peers, slots]


def _pad_flat_ops(reduced, p: int, n: int, min_bucket: int = 64):
    """Pad a reduced flat op batch to a power-of-two length so the stacked
    apply compiles one XLA program per BUCKET, not per batch size (a novel
    K otherwise stalls ~0.7 s in compilation — the r3 serving-tail spike:
    live mirrors produce a different backlog size every query).

    Padding rows can never change state: their slot ids start at ``n``
    (out of range — the scatter's FILL_OR_DROP default drops them, and the
    clamped gather only feeds a comparison they lose) and their value
    fields are all zero, i.e. cls 0 / rank 0 — the padding-never-wins
    invariant. (peer ``p-1``, ascending slots ≥ n) also preserves the
    sorted-unique (peer, slot) contract the scatter asserts to XLA."""
    k = len(reduced[0])
    bucket = max(min_bucket, 1 << max(k - 1, 1).bit_length())
    if bucket == k:
        return reduced
    pad = bucket - k
    peer = np.concatenate(
        [reduced[0], np.full(pad, p - 1, dtype=np.int32)]
    )
    slot = np.concatenate(
        [reduced[1], (n + np.arange(pad)).astype(np.int32)]
    )
    rest = tuple(
        np.concatenate([r, np.zeros(pad, dtype=r.dtype)])
        for r in reduced[2:]
    )
    return (peer, slot, *rest)


@jax.jit
def _peer_row_packed(table, peer):
    from ..ops.packed import CV_SHIFT, VID_MASK

    cv = table.cv[peer]
    return scans.RowView(
        cls=cv >> CV_SHIFT,
        khi=table.khi[peer],
        klo=table.klo[peer],
        vid=cv & VID_MASK,
    )


@jax.jit
def _gather_ranks_pairs(table, peers, slots):
    """rank1 point reads: the raw ranks (host decodes via RankIndex)."""
    return table.rank[peers, slots]


@jax.jit
def _rows_equal_one(field):
    """All peer rows of ONE field identical (tables_equal fast path)."""
    return jnp.all(field == field[0:1])


@jax.jit
def _rows_equal_two(vid, cls):
    return jnp.all(vid == vid[0:1]) & jnp.all(cls == cls[0:1])


@jax.jit
def _peer_row_rank1(table, peer, sranks, svids, cls_map, khi_map, klo_map):
    """rank1 row view: ranks decode to vids through the sorted-inverse
    binary search (ops.rank.decode_vids_rank1), then cls/khi/klo rebuild
    through the interner LUTs — the same RowView contract as the other
    layouts (absent ⇒ cls 0, vid 0)."""
    from ..ops.rank import decode_vids_rank1

    rank = table.rank[peer]
    present, vid = decode_vids_rank1(rank, sranks, svids)
    z = jnp.zeros_like(rank)
    vid = jnp.where(present, vid, z)
    return scans.RowView(
        cls=jnp.where(present, cls_map[vid], z),
        khi=jnp.where(present, khi_map[vid], z),
        klo=jnp.where(present, klo_map[vid], z),
        vid=vid,
    )


@jax.jit
def _peer_row_rank(table, peer, khi_map, klo_map):
    """Rank-layout row view: the table stores no key bits, so the row's
    khi/klo rebuild from vid through the interner LUTs (row-sized gather —
    queries order by value keys, not ranks)."""
    from ..ops.packed import CV_SHIFT, VID_MASK

    cv = table.cv[peer]
    vid = cv & VID_MASK
    present = (cv >> CV_SHIFT) > 0
    z = jnp.zeros_like(cv)
    return scans.RowView(
        cls=cv >> CV_SHIFT,
        khi=jnp.where(present, khi_map[vid], z),
        klo=jnp.where(present, klo_map[vid], z),
        vid=vid,
    )


class PeerNetworkSim:
    """P simulated peers over a topology, tables resident in device memory.

    Parameters
    ----------
    num_peers : int — simulated peer count (the reference's process count)
    capacity : int — leaf-slot capacity (grows by doubling)
    topology : "ring" | "chain" | "mesh" | "star" | "bridge" | Topology
    mode : "reference" (converged-state parity) | "lww" (Lamport LWW)
    mesh_devices : int | None — shard the peer axis over this many devices
    layout : "dense" (7-array, full metadata) | "packed" (3-array,
        12 B/entry — reference mode only; shards over a mesh like dense,
        see ops/packed.py) | "rank" (2-array, 8 B/entry) | "rank1"
        (1-array, 4 B/entry; see ops/rank.py)
    """

    def __init__(
        self,
        num_peers: int,
        capacity: int = 1024,
        topology: TopologyLike = "ring",
        mode: str = "reference",
        mesh_devices: Optional[int] = None,
        use_shard_map: bool = False,
        lean_gossip: bool = False,
        layout: str = "dense",
    ) -> None:
        if layout not in ("dense",) + PACKED_FAMILY:
            raise ValueError(f"unknown layout: {layout}")
        if layout in PACKED_FAMILY and mode != "reference":
            raise ValueError(f"{layout} layout supports reference mode only "
                             "(no writer/ctr metadata for lww priority)")
        self.layout = layout
        self.mode = mode
        self.use_shard_map = use_shard_map
        # lean gossip exchanges only the 4 value-key arrays (reference mode):
        # writer/ctr/tick keep their last locally-written values, matching
        # the reference's receive-side metadata reset (~1.75x merge traffic)
        self.lean_gossip = lean_gossip and mode == "reference"
        self.mesh = make_mesh(mesh_devices) if mesh_devices else None
        if self.mesh is not None:
            num_peers = pad_peers_to_mesh(num_peers, self.mesh)
        self.num_peers = num_peers
        self.topology = _resolve_topology(topology, num_peers)
        if self.topology.num_peers != num_peers:
            raise ValueError("topology size != num_peers")
        self.host = GraphHost(capacity)
        self.capacity = 0
        if layout == "packed":
            from ..ops.packed import init_packed as init
        elif layout in RANK_FAMILY:
            from ..ops.rank import RankIndex, init_rank, init_rank1

            init = init_rank1 if layout == "rank1" else init_rank
            # host order authority for the rank layouts: vid -> 31-bit
            # gap rank, strictly monotone in (cls, khi, klo, vid)
            self.rank_index = RankIndex()
            self._rank_str_epoch = -1
        else:
            init = init_table
        if self.mesh is None:
            self.table = init(num_peers, capacity)
        else:
            # built in place, one shard per device: a table larger than
            # one device never lands whole on the first one
            self.table = jax.jit(
                init, static_argnums=(0, 1),
                out_shardings=peer_sharding(self.mesh),
            )(num_peers, capacity)
        self.capacity = capacity
        self.tick = 0
        self._clock = np.zeros(num_peers, dtype=np.int64)
        # scalar-put hot path reads/writes this LIST shadow (plain list
        # index ops beat np scalar indexing ~3x); the np array is
        # materialized at every vectorized boundary (_clock_sync_np)
        self._clock_list = [0] * num_peers
        self._pending: List[List[Tuple[int, int, int, int, int, int]]] = [
            [] for _ in range(num_peers)
        ]
        self._pending_bulk: List[Tuple[np.ndarray, ...]] = []
        # live-bridge fabric (models/bridge.py): ONE lock serializes every
        # bridge pump/flush/view-query against this sim, and the stage
        # registry lets any pump drain EVERY attached bridge's staged
        # writes — multi-bridge sims converge over all write streams no
        # matter whose handle flushes
        import threading

        self._bridge_lock = threading.Lock()
        self._bridge_stages: List[Tuple[Any, int]] = []
        # scalar-put fast path: enabled until any hook or schema registers
        self._fast_put_ok = True
        # scalar-put fast-path memoization (see _put_scalar_fast)
        self._slot_cache: Dict[str, int] = {}
        self._enc_num_cache: Dict[Any, Tuple[int, int, int, int]] = {}
        self._enc_str_cache: Dict[str, Tuple[int, int, int, int]] = {}
        self._enc_str_epoch = -1
        self._subs: List[dict] = []
        from .ingress import EngineHooks, EngineValidation

        # batch-ingress pipeline (SURVEY §7 stage 5): middleware hooks +
        # schema validation, both zero-cost until something registers
        self.validation = EngineValidation(self)
        self.hooks = EngineHooks(self)
        self.stats = {
            "ops_enqueued": 0,
            "ops_applied": 0,
            "ops_rejected": 0,
            "gossip_rounds": 0,
            "windowed_rounds": 0,
            "merged_entries": 0,
            "steps": 0,
        }
        self.last_residual: Optional[int] = None

    # ------------------------------------------------------------ write path

    def put(self, peer: int, path: str, value: Any) -> bool:
        """Queue a local put at ``peer`` (applied on the next step). Object
        values decompose into leaves (DESIGN.md leaf model). Put hooks may
        veto/mutate; schema-bound paths validate with typed errors (both
        mirror the reference write path, SURVEY §3.2). Returns False iff the
        put was vetoed/rejected."""
        if self._fast_put_ok and type(value) is not dict:
            # hot scalar path (the reference's primary API shape,
            # bullet.js:700-703): memoized path->slot and numeric
            # value->encoding, no hook/flatten machinery. The flag is
            # cleared permanently by ANY hook/schema registration
            # (ingress.py _disable_fast_put). The common numeric-hit case
            # is inlined here; misses and other types take the helper.
            enc = None
            t = type(value)
            if t is float or t is int:
                enc = self._enc_num_cache.get(value)
            if enc is not None:
                slot = self._slot_cache.get(path)
                if slot is not None:
                    clock = self._clock_list
                    c = clock[peer] + 1
                    clock[peer] = c
                    self._pending[peer].append((slot, *enc, c))
                    self.stats["ops_enqueued"] += 1
                    return True
            return self._put_scalar_fast(peer, path, value)
        if self.hooks.active:
            cont, path, value = self.hooks.run_put(peer, path, value)
            if not cont:
                return False
        if self.validation.active and not self.validation.check_put(path, value):
            return False
        leaves = list(flatten_value(path, value))
        if any(not leaf_path for leaf_path, _ in leaves):
            raise ValueError(
                "cannot put a scalar at the root path (empty leaf path)"
            )
        if len(leaves) > 4:
            # tree puts batch through the bulk machinery: one native
            # intern_batch call + vectorized value encode instead of a
            # Python loop per leaf (outcome identical — the merge is a
            # lattice, so enqueue order never affects converged state)
            from ..utils.encode import bulk_encode_values

            slots = self.host.intern_batch([p for p, _ in leaves])
            cls, khi, klo, vid = bulk_encode_values(
                self.host.values, [v for _, v in leaves]
            )
            self._enqueue_bulk(
                np.full(len(leaves), peer, dtype=np.int32),
                slots.astype(np.int32), cls, khi, klo, vid,
            )
        else:
            for leaf_path, leaf_value in leaves:
                slot = self.host.intern_path(leaf_path)
                cls, khi, klo, vid = self.host.encode_value(leaf_value)
                c = self._clock_list[peer] + 1
                self._clock_list[peer] = c
                self._pending[peer].append(
                    (slot, cls, khi, klo, vid, c)
                )
                self.stats["ops_enqueued"] += 1
        self.hooks.queue_after_put(peer, path, value)
        return True

    # scalar-fast-path cache bound: keeps pathological workloads (e.g.
    # NaN-keyed or unbounded-distinct values) from growing the dicts
    # without limit; a clear only costs re-encoding
    _FAST_CACHE_MAX = 1 << 20

    def _put_scalar_fast(self, peer: int, path: str, value: Any) -> bool:
        """Hot scalar ``put``: no hooks, no validation, non-dict value.

        Two memoizations carry the speedup: path -> slot (the interner is
        append-only, so slots are stable), and numeric value -> encoding
        (number order keys never re-rank). String encodings re-rank when
        the order-statistic tree rebalances, so the string cache is
        validated against the interner epoch and flushed on change."""
        if not path:
            raise ValueError(
                "cannot put a scalar at the root path (empty leaf path)"
            )
        slot = self._slot_cache.get(path)
        if slot is None:
            slot = self.host.intern_path(path)
            if len(self._slot_cache) >= self._FAST_CACHE_MAX:
                self._slot_cache.clear()
            self._slot_cache[path] = slot
        t = type(value)
        if (t is float or t is int) and value == value:
            enc = self._enc_num_cache.get(value)
            if enc is None:
                enc = self.host.encode_value(value)
                if len(self._enc_num_cache) >= self._FAST_CACHE_MAX:
                    self._enc_num_cache.clear()
                self._enc_num_cache[value] = enc
        elif t is str:
            epoch = self.host.values.epoch
            if epoch != self._enc_str_epoch:
                self._enc_str_cache.clear()
                self._enc_str_epoch = epoch
            enc = self._enc_str_cache.get(value)
            if enc is None:
                enc = self.host.encode_value(value)
                if self.host.values.epoch != epoch:
                    # this very insert rebalanced: ranks just moved
                    self._enc_str_cache.clear()
                    self._enc_str_epoch = self.host.values.epoch
                if len(self._enc_str_cache) >= self._FAST_CACHE_MAX:
                    self._enc_str_cache.clear()
                self._enc_str_cache[value] = enc
        else:
            enc = self.host.encode_value(value)
        clock = self._clock_list
        c = clock[peer] + 1
        clock[peer] = c
        self._pending[peer].append((slot, *enc, c))
        self.stats["ops_enqueued"] += 1
        return True

    def put_bulk(self, peers, paths, values) -> None:
        """Vectorized ingestion: enqueue many scalar puts at once.

        ``peers`` — int array [K], or a single int to load every row into
        one peer; ``values`` — numeric array [K] (the fast path) or any list
        of leaf values; ``paths`` — list of K path strings, or an int32
        array of pre-interned slot ids (see ``intern_path``).
        This is the framework's bulk data loader: per-op Python overhead is
        replaced by numpy passes (unique values intern once).
        """
        peers = np.asarray(peers, dtype=np.int32)
        if peers.ndim == 0:
            peers = np.full(len(paths), int(peers), dtype=np.int32)
        k = len(peers)
        if k == 0:
            return
        # pre-interned slot-id batches are the raw device-feed API and skip
        # ALL hooks by design (documented)
        pre_interned = (
            isinstance(paths, np.ndarray) and paths.dtype.kind == "i"
        )
        if self.hooks._put and not pre_interned:
            # host put hooks must see bulk rows too (veto/mutate parity
            # with scalar puts); this per-row pass only runs when hooks are
            # registered — the vectorized fast path is otherwise untouched
            kept_p, kept_paths, kept_vals = [], [], []
            vals_seq = (
                values.tolist() if isinstance(values, np.ndarray) else values
            )
            for p, path, value in zip(peers, paths, vals_seq):
                cont, path, value = self.hooks.run_put(int(p), path, value)
                if cont:
                    kept_p.append(int(p))
                    kept_paths.append(path)
                    kept_vals.append(value)
            if not kept_p:
                return
            peers = np.asarray(kept_p, dtype=np.int32)
            paths, values = kept_paths, kept_vals
            k = len(peers)
        slots = (
            paths.astype(np.int32) if pre_interned
            else self.host.intern_batch(paths)  # one native C call
        )

        # the numeric fast path requires an EXPLICIT numeric ndarray:
        # np.asarray on a mixed list would silently coerce bools (and
        # mixed strings) to numbers, diverging from scalar-put encoding
        if isinstance(values, np.ndarray) and values.dtype.kind in "ifu":
            from ..utils.encode import bulk_encode_numbers

            raw_vals: Any = values
            numeric = True
            cls, khi, klo, vid = bulk_encode_numbers(self.host.values, values)
        else:
            # list / mixed / string batches: vectorized per-class paths
            # (numbers through the bits map, strings through ONE batch
            # index insert) with per-element class detection
            from ..utils.encode import bulk_encode_values

            raw_vals = (
                values.tolist() if isinstance(values, np.ndarray)
                else list(values)
            )
            numeric = False
            cls, khi, klo, vid = bulk_encode_values(self.host.values, raw_vals)

        # strict schema constraints the device mask can't express (integer
        # integralness, boolean identity, string/array length) drop here,
        # while the raw values are still in hand; type/range/enum veto
        # stays on device
        if self.validation.active:
            drop = self.validation.strict_bulk_mask(slots, raw_vals)
            if drop is not None and drop.any():
                for i in np.nonzero(drop)[0]:
                    path = self.host.paths.path(int(slots[i]))
                    val = float(raw_vals[i]) if numeric else raw_vals[i]
                    # re-run the host checker for the exact typed error
                    self.validation.host.check_write(path, val)
                keep = ~drop
                peers, slots, cls, khi, klo, vid = (
                    a[keep] for a in (peers, slots, cls, khi, klo, vid)
                )
                raw_vals = (
                    raw_vals[keep] if numeric
                    else [v for v, kp in zip(raw_vals, keep) if kp]
                )
                self.stats["ops_rejected"] += int(drop.sum())
                k = len(peers)
                if k == 0:
                    return

        # afterPut hooks + "write" events fire for accepted rows — exactly
        # like scalar puts (which queue before apply; merge losers still
        # fire, matching the reference's afterPut-after-setData contract,
        # bullet-middleware.js:112-131). With schemas bound, each row
        # re-checks silently so rows the device mask will veto don't claim
        # a write happened (the device path owns their typed errors).
        # NOTE: with listeners/hooks registered this pass is O(K) Python —
        # per-row hook delivery is inherently host-side (the reference's
        # afterPut receives (path, value) per write). Bulk loads that need
        # max ingest rate should register listeners after loading; the
        # vectorized device path is untouched either way. The path reverse
        # lookups are batched per unique slot below.
        if not pre_interned and (self.hooks._after_put or self.hooks._events):
            check = (
                self.validation.host.check_write
                if self.validation.active else None
            )
            upaths = {
                int(s): self.host.paths.path(int(s))
                for s in np.unique(slots)
            }
            for i in range(k):
                path = upaths[int(slots[i])]
                val = float(raw_vals[i]) if numeric else raw_vals[i]
                if check is not None and not check(path, val, report=False):
                    continue
                self.hooks.queue_after_put(int(peers[i]), path, val)

        self._enqueue_bulk(peers, slots, cls, khi, klo, vid)
        if self.layout in RANK_FAMILY:
            # stage rank inserts NOW, while the encoded batch is hot — the
            # apply-time _sync_rank_index then finds nothing new and the
            # fresh-load fold stops serializing behind the insert
            self._stage_rank_inserts()

    def _enqueue_bulk(self, peers, slots, cls, khi, klo, vid) -> None:
        """Stamp per-op Lamport counters (clock[peer] + within-batch
        sequence) and queue one bulk chunk — the single enqueue point shared
        by ``put_bulk`` and batched tree ``put``s."""
        seq, counts = _group_positions(peers, self.num_peers)
        self._clock_sync_np()
        ctr = (self._clock[peers] + seq + 1).astype(np.int32)
        self._clock += counts
        self._clock_list = self._clock.tolist()
        self._pending_bulk.append((peers, slots, cls, khi, klo, vid, ctr))
        self.stats["ops_enqueued"] += len(peers)

    def _clock_sync_np(self) -> None:
        np.copyto(self._clock, self._clock_list)

    def _clock_snapshot(self) -> np.ndarray:
        self._clock_sync_np()
        return self._clock.copy()

    def intern_path(self, path: str) -> int:
        """Pre-intern a path for slot-id based ``put_bulk`` ingestion."""
        return self.host.intern_path(path)

    def remove(self, peer: int, path: str) -> bool:
        """Put null at ``path`` and every known descendant leaf (the leaf
        model's rendering of the reference's subtree null,
        /root/reference/src/bullet.js:755-758). In reference mode null loses
        to greater scalars — exactly the reference's quirk; lww deletes.
        Delete hooks may veto (bullet-middleware.js:137-186)."""
        if self.hooks.active and not self.hooks.run_delete(peer, path):
            return False
        pid = self.host.intern_path(path)
        self.put(peer, path, None)
        for slot in self.host.leaf_slots_under(pid):
            self.put(peer, self.host.paths.path(slot), None)
        if self.hooks.active:
            self.hooks.fire_after_delete(peer, path)
        return True

    # ----------------------------------------------------------------- step

    def _drain_ops(self) -> Optional[OpBatch]:
        """Pack queued ops (scalar puts + bulk batches) into dense [P, B]
        arrays via numpy scatter."""
        peer_list, field_cols = [], [[] for _ in range(6)]
        for p, ops in enumerate(self._pending):
            for op in ops:
                peer_list.append(p)
                for f in range(6):
                    field_cols[f].append(op[f])
            ops.clear()
        chunks_peers = []
        chunks_fields = [[] for _ in range(6)]
        if peer_list:
            chunks_peers.append(np.asarray(peer_list, dtype=np.int32))
            for f in range(6):
                chunks_fields[f].append(np.asarray(field_cols[f], dtype=np.int32))
        for bulk in self._pending_bulk:
            chunks_peers.append(bulk[0])
            for f in range(6):
                chunks_fields[f].append(bulk[f + 1])
        self._pending_bulk.clear()
        if not chunks_peers:
            return None

        peers = np.concatenate(chunks_peers)
        flat = [np.concatenate(c) for c in chunks_fields]
        bpos, counts = _group_positions(peers, self.num_peers)
        # pow2 batch width: one compiled apply per BUCKET, not per width
        # (padded entries are cls 0 — they never win; see _pad_flat_ops)
        batch = max(8, 1 << max(int(counts.max()) - 1, 1).bit_length())

        fields = [np.zeros((self.num_peers, batch), dtype=np.int32) for _ in range(6)]
        for f in range(6):
            fields[f][peers, bpos] = flat[f]
        arrays = [jnp.asarray(f) for f in fields]
        if self.mesh is not None:
            sharding = peer_sharding(self.mesh)
            arrays = [jax.device_put(a, sharding) for a in arrays]
        return OpBatch(*arrays)

    def _ensure_capacity(self) -> None:
        needed = len(self.host.paths)
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self.capacity
        self.table = type(self.table)(
            *(jnp.pad(f, ((0, 0), (0, pad))) for f in self.table)
        )
        if self.mesh is not None:
            self.table = shard_table(self.table, self.mesh)
        self.capacity = new_cap

    def _ingress(self, ops: Optional[OpBatch]) -> Optional[OpBatch]:
        """Batch-ingress pipeline between drain and apply (SURVEY §7 stage 5):
        traced put transforms run inside one jitted chain, then the compiled
        schema rules veto invalid ops on device (cls=0 ⇒ guaranteed loser);
        rejected rows produce host-side typed errors."""
        if ops is None:
            return None
        transforms = tuple(self.hooks._traced_put)
        rules = self.validation.rules() if self.validation.active else None
        if not transforms and rules is None:
            return ops
        struct = self.host.struct()
        if transforms:
            from .ingress import traced_pipeline

            ops = traced_pipeline(transforms)(ops, struct)
        if rules is not None:
            from .ingress import invalid_op_mask, veto_ops

            invalid = invalid_op_mask(ops, struct, rules)
            rejected = self.validation.report_rejections(ops, invalid)
            if rejected:
                ops = veto_ops(ops, invalid)
                self.stats["ops_rejected"] += rejected
        return ops

    def _maybe_rekey(self) -> None:
        if not self.host.needs_rekey:
            return
        if self.layout in RANK_FAMILY:
            # a string-rank rebalance moves khi/klo BITS but preserves the
            # value ORDER, and the rank table stores no key bits at all —
            # the device state is already correct. The RankIndex's stored
            # key columns refresh lazily via the interner epoch in
            # _sync_rank_index (before any insert compares against them).
            self.host.needs_rekey = False
            return
        cls_map, khi_map, klo_map = self.host.key_tables()
        rekey = _rekey_packed if self.layout == "packed" else _rekey
        self.table = rekey(
            self.table,
            jnp.asarray(cls_map),
            jnp.asarray(khi_map),
            jnp.asarray(klo_map),
        )
        self.host.needs_rekey = False

    def _stage_rank_inserts(self) -> None:
        """Rank-index maintenance WITHOUT the device rekey: refresh stored
        key columns after a string rebalance and assign ranks to newly
        interned vids. Called from ``put_bulk`` so bulk ingest pays the
        insert while the encoded batch is still hot (VERDICT r4 item 1:
        the fresh-load apply previously serialized this behind the fold);
        any respread's device rekey still defers to the next
        ``_sync_rank_index`` (apply/read), which sees ``needs_rekey``."""
        vals = self.host.values
        if self._rank_str_epoch != vals.epoch:
            cls_map, khi_map, klo_map = self.host.key_tables()
            self.rank_index.refresh_keys(cls_map, khi_map, klo_map)
            self._rank_str_epoch = vals.epoch
        n_ranked = len(self.rank_index)
        if len(vals) > n_ranked:
            cls_map, khi_map, klo_map = self.host.key_tables()
            new = np.arange(n_ranked, len(vals))
            self.rank_index.insert_batch(
                new, cls_map[new], khi_map[new], klo_map[new]
            )

    def _sync_rank_index(self) -> None:
        """Bring the RankIndex up to date with the interner (rank layout):
        refresh stored key columns after a string rebalance (epoch bump),
        assign ranks to newly interned vids, and — if a gap exhausted and
        the rank space respread — re-gather the device table's ranks
        through the fresh vid -> rank LUT so ops and table always compare
        under ONE map version. The rank1 layout has no vid column to
        re-gather through; its stale ranks decode via the PRE-respread
        inverse the RankIndex snapshots (prev_inverse → rekey_rank1)."""
        from ..ops.rank import rekey_rank, rekey_rank1

        self._stage_rank_inserts()
        if self.rank_index.needs_rekey:
            if self.layout == "rank1":
                osr, osv = self.rank_index.prev_inverse
                self.table = rekey_rank1(
                    self.table, jnp.asarray(osr), jnp.asarray(osv),
                    jnp.asarray(self.rank_index.rank_map()),
                )
            else:
                self.table = rekey_rank(
                    self.table, jnp.asarray(self.rank_index.rank_map())
                )
            self.rank_index.needs_rekey = False

    def _apply_pending(self) -> int:
        """Drain + ingress + apply, layout-dispatched; returns applied count."""
        if self.layout in PACKED_FAMILY:
            return self._apply_pending_packed()
        drained = self._drain_ops()
        if drained is None:
            return 0
        ops = self._ingress(drained)
        self.table, applied = apply_ops(
            self.table, ops, jnp.int32(self.tick), mode=self.mode
        )
        return int(applied)

    def _drain_flat(self):
        """Queued ops as flat numpy arrays (peer, slot, cls, khi, klo, vid) —
        the packed-layout ingestion shape (no dense [P, B] padding)."""
        chunks = []
        for p, ops in enumerate(self._pending):
            if ops:
                a = np.asarray(ops, dtype=np.int32)  # rows: slot..ctr
                chunks.append(
                    (np.full(len(ops), p, dtype=np.int32),
                     a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4])
                )
                ops.clear()
        for bulk in self._pending_bulk:
            peers, slots, cls, khi, klo, vid, _ctr = bulk
            chunks.append((peers, slots, cls, khi, klo, vid))
        self._pending_bulk.clear()
        if not chunks:
            return None
        return tuple(
            np.concatenate([c[i] for c in chunks]) for i in range(6)
        )

    def _apply_pending_packed(self) -> int:
        """Packed apply: flat ingress (traced transforms + device validation
        veto), host lattice pre-reduction per (peer, slot), then ONE
        gather+scatter apply — no dense batch, no scan (ops/packed.py)."""
        from ..ops.packed import (
            MAX_VID,
            apply_flat_packed_stacked,
            reduce_flat_ops,
        )

        flat = self._drain_flat()
        if flat is None:
            return 0
        if len(self.host.values) > MAX_VID:
            raise RuntimeError(
                f"packed layout caps distinct values at 2^28; interner "
                f"holds {len(self.host.values)} — use layout='dense'"
            )
        peer, slot, cls, khi, klo, vid = flat
        if self.hooks._traced_put or (
            self.validation.active and self.validation.rules() is not None
        ):
            # same ingress pipeline as the dense path — OpBatch fields are
            # rank-agnostic, so flat [K] arrays go straight through
            ops = self._ingress(OpBatch(
                slot=jnp.asarray(slot), cls=jnp.asarray(cls),
                khi=jnp.asarray(khi), klo=jnp.asarray(klo),
                vid=jnp.asarray(vid),
                ctr=jnp.zeros(slot.shape, dtype=jnp.int32),
            ))
            slot, cls, khi, klo, vid = (
                np.asarray(ops.slot), np.asarray(ops.cls),
                np.asarray(ops.khi), np.asarray(ops.klo), np.asarray(ops.vid),
            )
        if self.layout in RANK_FAMILY:
            from ..ops.packed import CV_SHIFT
            from ..ops.rank import reduce_flat_ops_rank

            # rank stamping must see every new vid AND a device table
            # coherent with the same map version (see _sync_rank_index)
            self._sync_rank_index()
            rmap = self.rank_index.rank_map()
            cv_f = (
                (cls.astype(np.int64) << CV_SHIFT) | vid
            ).astype(np.int32)
            reduced = reduce_flat_ops_rank(peer, slot, rmap[vid], cv_f)
            if reduced is not None and self.layout == "rank1":
                # rank decides the winner alone (bijection refining the
                # packed chain); the cv column is payload the 4 B/entry
                # layout simply doesn't store
                reduced = reduced[:3]
        else:
            reduced = reduce_flat_ops(peer, slot, cls, khi, klo, vid)
        if reduced is None:
            return 0
        # ONE stacked h2d transfer for the whole reduced batch
        p_, n_ = self.table[0].shape
        reduced = _pad_flat_ops(reduced, p_, n_)
        if self.layout == "rank1":
            from ..ops.rank import apply_flat_rank1_stacked

            self.table, applied = apply_flat_rank1_stacked(
                self.table, jnp.asarray(np.stack(reduced))
            )
        elif self.layout == "rank":
            from ..ops.rank import apply_flat_rank_stacked

            self.table, applied = apply_flat_rank_stacked(
                self.table, jnp.asarray(np.stack(reduced))
            )
        else:
            self.table, applied = apply_flat_packed_stacked(
                self.table, jnp.asarray(np.stack(reduced))
            )
        return int(applied)

    def warm_apply_buckets(self, max_ops: int = 1 << 16) -> int:
        """Precompile the flat-apply bucket ladder up to ``max_ops``.

        Serving warmup: applies run one compiled program per pow2 batch
        bucket (see ``_pad_flat_ops``); a live mirror produces a different
        backlog size every query, so without warmup the FIRST query to hit
        each bucket pays that bucket's XLA compile (~0.7 s) mid-request —
        the r3 serving-bench p95. This drives an all-padding batch through
        every bucket so the compiles happen before traffic. State-invariant
        (padding never wins); returns the number of buckets warmed.

        Packed-family layouts only (the serving layouts); with the
        persistent compile cache the cost is paid once per shape ever."""
        if self.layout not in PACKED_FAMILY:
            return 0
        from ..ops.packed import apply_flat_packed_stacked

        if self.layout == "rank1":
            from ..ops.rank import apply_flat_rank1_stacked as apply_stacked

            rows = 3
        elif self.layout == "rank":
            from ..ops.rank import apply_flat_rank_stacked as apply_stacked

            rows = 4
        else:
            apply_stacked, rows = apply_flat_packed_stacked, 5
        self._sync_device_state()
        p_, n_ = self.table[0].shape
        empty = tuple(np.zeros(0, dtype=np.int32) for _ in range(rows))
        warmed = 0
        bucket = 64
        while bucket <= max_ops:
            padded = _pad_flat_ops(empty, p_, n_, min_bucket=bucket)
            self.table, applied = apply_stacked(
                self.table, jnp.asarray(np.stack(padded))
            )
            assert int(applied) == 0  # padding must never win
            warmed += 1
            bucket <<= 1
        return warmed

    def _one_round(self):
        if self.layout in PACKED_FAMILY:
            from ..ops.packed import gossip_round_packed

            return gossip_round_packed(
                self.table, self.topology, mesh=self._gossip_mesh()
            )
        return gossip_round(
            self.table, self.topology, self.mode,
            mesh=self._gossip_mesh(), lean=self.lean_gossip,
        )

    def step(self, rounds: int = 1) -> int:
        """Apply queued ops, run ``rounds`` gossip rounds; returns residual
        (entries changed in the last round)."""
        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        residual = 0
        for _ in range(rounds):
            self.table, changed = self._one_round()
            residual = int(changed)
            self.stats["gossip_rounds"] += 1
            self.stats["merged_entries"] += residual
        self.stats["steps"] += 1
        self.last_residual = residual if rounds else None
        self._sync_clocks()
        self._fire_subscriptions()
        return residual

    def _fast_forward_route(self) -> str:
        """Which implementation fast_forward uses for this sim state:
        "spmd" (shard_map window, one boundary collective per pass),
        "xla" (whole-table window join; on a data-mesh table its rolls
        lower to collectives), or "step" (sequential delegation: dense
        layouts and generic topologies)."""
        if (
            self.layout not in PACKED_FAMILY
            or self.topology.kind not in ("ring", "chain")
        ):
            return "step"
        if self._gossip_mesh() is not None:
            return "spmd"
        return "xla"

    def fast_forward(self, rounds: int) -> int:
        """Advance EXACTLY ``rounds`` gossip rounds, bit-identical to
        ``step(rounds)`` (same final table, same returned last-round
        residual), but computed as radius-m window joins in O(log m)
        3-way merges instead of m sequential rounds — the merge is an
        idempotent lattice join, so m Jacobi rounds ≡ one radius-m window
        (ops/packed.py ``ring_window_packed_xla``).

        Routing (``_fast_forward_route``): packed-family ring/chain sims
        only. Under a shard_map mesh, the explicit-SPMD window exchanges
        m boundary rows in ONE collective per m rounds
        (``ring_window_shardmap_packed`` — passes capped at the
        per-device row count). Otherwise one whole-table XLA window
        covers the jump, including data-mesh sharding (the rolls lower to
        collectives). Dense layouts and generic topologies delegate to
        ``step(rounds)``. A window pass whose round-m residual is 0 ends
        the jump early (an identity round ⇒ fixed point ⇒ the remaining
        rounds are no-ops, so exactness and the classic residual are
        preserved).

        Accounting: ``stats["gossip_rounds"]`` advances by ``rounds``,
        but intermediate rounds are never materialized, so per-round
        ``merged_entries`` cannot be tracked — the window path counts
        only the FINAL round's residual there and records the skipped
        rounds in ``stats["windowed_rounds"]``. Use ``step`` when the
        per-round merge counts are themselves the result."""
        route = self._fast_forward_route()
        if rounds <= 0 or route == "step":
            return self.step(rounds)

        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        wrap = self.topology.kind == "ring"
        p = self.table[0].shape[0]
        left = rounds
        residual = 0
        while left:
            if route == "spmd":
                from ..parallel.shardmap_gossip import (
                    ring_window_shardmap_packed,
                )

                spmd_mesh = self._gossip_mesh()
                m = min(left, p // spmd_mesh.devices.size)
                self.table, changed = ring_window_shardmap_packed(
                    self.table, spmd_mesh, wrap, m
                )
            else:  # "xla"
                from ..ops.packed import ring_window_packed_xla

                m = left
                self.table, changed = ring_window_packed_xla(
                    self.table, wrap, m
                )
            left -= m
            residual = int(changed)
            if residual == 0:
                # round-m residual 0 ⇒ round m was the identity ⇒ fixed
                # point: every remaining round is a no-op, so skipping
                # them preserves the exact-k contract (and the classic
                # loop's last-round residual, also 0)
                break
        self.stats["gossip_rounds"] += rounds
        self.stats["windowed_rounds"] += rounds
        self.stats["merged_entries"] += residual
        self.stats["steps"] += 1
        self.last_residual = residual
        self._sync_clocks()
        self._fire_subscriptions()
        return residual

    def run_until_converged(self, max_rounds: Optional[int] = None) -> int:
        """Apply pending ops then gossip to the fixed point on-device
        (compiled while_loop). Returns rounds executed."""
        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        if max_rounds is None:
            max_rounds = max(2 * self.topology.diameter + 2, 4)
        _, runner = self._convergence_strategy()
        return runner(max_rounds)

    # -- convergence strategy dispatch (see CONVERGENCE_STRATEGIES) --------

    def _convergence_cell(self) -> ConvergenceCell:
        return ConvergenceCell(layout=self.layout)

    def _convergence_strategy(self) -> Tuple[str, Callable[[int], int]]:
        """(row name, runner) for the current sim state — the single place
        run_until_converged picks a loop implementation."""
        cell = self._convergence_cell()
        for name, pred, method in CONVERGENCE_STRATEGIES:
            if pred(cell):
                return name, getattr(self, method)
        raise AssertionError("unreachable: dense-loop matches every cell")

    def _finish_converge(self, rounds, final_changed, sync_clocks) -> int:
        rounds = int(rounds)
        self.stats["gossip_rounds"] += rounds
        self.stats["steps"] += 1
        # honest residual: 0 only if the loop actually reached the fixed
        # point; nonzero when max_rounds cut it off mid-convergence
        self.last_residual = int(final_changed)
        if sync_clocks:
            self._sync_clocks()
        self._fire_subscriptions()
        return rounds

    def _star_hub(self) -> int:
        if self.topology.name != "star":
            return 0
        return int(np.argmax(self.topology.degree()))

    def _converge_packed_loop(self, max_rounds: int) -> int:
        """Packed whole-table while_loop (shard_map collectives on a
        mesh, XLA rounds otherwise)."""
        from ..ops.packed import gossip_until_converged_packed

        self.table, rounds, final_changed = gossip_until_converged_packed(
            self.table, jnp.asarray(self.topology.neighbors),
            self.topology.kind, max_rounds,
            spmd_mesh=self._gossip_mesh(),
            topo_name=self.topology.name, hub=self._star_hub(),
        )
        return self._finish_converge(rounds, final_changed, sync_clocks=False)

    def _converge_dense_loop(self, max_rounds: int) -> int:
        """Dense whole-table while_loop for any topology (star hub path,
        generic neighbor gather, shard_map collectives on a mesh)."""
        self.table, rounds, final_changed = gossip_until_converged_device(
            self.table, jnp.asarray(self.topology.neighbors),
            self.topology.kind, self.mode, max_rounds,
            lean=self.lean_gossip, spmd_mesh=self._gossip_mesh(),
            topo_name=self.topology.name, hub=self._star_hub(),
        )
        return self._finish_converge(rounds, final_changed, sync_clocks=True)

    def reconcile(self) -> None:
        """Directly reconcile every replica to the gossip fixed point —
        WITHOUT simulating protocol rounds — on ANY topology.

        Gossip is pull-based, so peer p's fixed point is the lattice join
        over every peer p can REACH along neighbor edges (the merge is a
        commutative/associative/idempotent join, so the fixed point is
        delivery-order-independent — a tested invariant). On a STRONGLY
        connected topology every reachable set is all of P and reconcile
        jumps there in ceil(log2 P) doubling merges. Otherwise (directed /
        partitioned topologies) it runs a dynamic program over the SCC
        condensation: components in ascending id order (= reverse
        topological order, see Topology.strong_components) join their
        member rows plus one representative row per successor component —
        already holding ITS closure — and broadcast to members. Either way
        the result is bit-identical to run_until_converged's fixed point.
        This is the production anti-entropy path: use it when you want the
        reconciled state, and run_until_converged when the simulation
        itself (round counts, per-round residuals) is the result. Pending
        ops apply first; subscriptions fire as usual."""
        self._ensure_capacity()
        self._maybe_rekey()
        self.tick += 1
        self.stats["ops_applied"] += self._apply_pending()
        self.hooks.fire_after_puts()
        if not self.topology.is_connected():
            self._reconcile_weak()
        elif self.layout in PACKED_FAMILY and self._gossip_mesh() is not None:
            # the doubling join IS one full-mesh round; its shard_map form
            # rolls by static shifts through ppermute instead of letting
            # the partitioner gather the table for the traced-shift loop
            from ..parallel.shardmap_gossip import reconcile_shardmap_packed

            self.table = reconcile_shardmap_packed(
                self.table, self._gossip_mesh()
            )
        elif self.layout in PACKED_FAMILY:
            from ..ops.packed import reconcile_packed_xla

            self.table = reconcile_packed_xla(self.table)
        else:
            self.table, _ = _reconcile_dense_jit(
                self.table, self.mode, self.lean_gossip
            )
        self.stats["steps"] += 1
        self.last_residual = 0
        self._sync_clocks()
        self._fire_subscriptions()

    def _reconcile_weak(self) -> None:
        """Reconcile a non-strongly-connected topology: per-SCC-closure
        joins over the condensation. Components are processed in
        ascending id order, which Topology.strong_components guarantees
        is reverse topological order of the condensation — every
        component this one pulls from is already at ITS closure, so one
        representative row per successor suffices (all rows of a
        finalized component are identical). Index lists are padded to
        powers of two with duplicates, bounding compile variants to
        O(log^2 P) for any topology."""
        comp = self.topology.strong_components()
        n_comp = int(comp.max()) + 1
        members = [np.flatnonzero(comp == c) for c in range(n_comp)]
        succs: List[set] = [set() for _ in range(n_comp)]
        for p in range(self.num_peers):
            cp = int(comp[p])
            for q in self.topology.neighbors[p]:
                if q >= 0 and comp[q] != cp:
                    succs[cp].add(int(comp[q]))
        for c in range(n_comp):
            idx = [
                *members[c].tolist(),
                *(int(members[s][0]) for s in sorted(succs[c])),
            ]
            if len(idx) == 1:
                continue  # singleton with no pulls: already its closure
            k = 1 << (len(idx) - 1).bit_length()
            idx_arr = jnp.asarray(
                np.asarray(idx + [idx[0]] * (k - len(idx)), np.int32)
            )
            mem = members[c].tolist()
            m = 1 << (len(mem) - 1).bit_length()
            mem_arr = jnp.asarray(
                np.asarray(mem + [mem[0]] * (m - len(mem)), np.int32)
            )
            if self.layout in PACKED_FAMILY:
                self.table = _closure_join_packed(
                    self.table, idx_arr, mem_arr
                )
            else:
                self.table = _closure_join_dense(
                    self.table, idx_arr, mem_arr, self.mode,
                    self.lean_gossip,
                )

    def _sync_clocks(self) -> None:
        """Lamport clock advance: after gossip every peer's clock must exceed
        any counter it has seen, or later writes could lose ties (lww only;
        reference mode resolves by value and doesn't need it)."""
        if self.mode != "lww":
            return
        row_max = np.asarray(jnp.max(self.table.ctr, axis=1)).astype(np.int64)
        self._clock_sync_np()
        np.maximum(self._clock, row_max, out=self._clock)
        self._clock_list = self._clock.tolist()

    def _gossip_mesh(self):
        """Mesh for the explicit shard_map gossip path (opt-in)."""
        return self.mesh if (self.use_shard_map and self.mesh is not None) else None

    def converged(self) -> bool:
        """True iff one more gossip round would change nothing (state is
        not advanced). Packed ring/chain shapes use a count-only probe
        that writes nothing table-sized; other configurations probe on a
        scratch copy."""
        if (
            self.layout in PACKED_FAMILY
            and self.topology.kind in ("ring", "chain")
            and self._gossip_mesh() is None
        ):
            from ..ops.packed import count_changes_round_packed

            self._sync_device_state()
            changed = count_changes_round_packed(
                self.table, self.topology.kind == "ring"
            )
            return int(changed) == 0
        _, changed = self._one_round()
        return int(changed) == 0

    # ----------------------------------------------------------------- reads

    def _sync_device_state(self) -> None:
        """Reads may follow fresh path/value interning: grow the table and
        re-key BEFORE any device access, or gathers clamp to wrong slots and
        scans see mismatched struct/table shapes."""
        self._ensure_capacity()
        self._maybe_rekey()

    def _decode_slots(self, peer: int, slots: List[int]) -> Dict[int, Any]:
        if not slots:
            return {}
        self._sync_device_state()
        arr = jnp.asarray(np.asarray(slots, dtype=np.int32))
        if self.layout == "rank1":
            ranks = np.asarray(
                _gather_ranks_pairs(self.table, jnp.int32(peer), arr)
            )
            vids = self.rank_index.decode_ranks(ranks)
            sel = vids >= 0
            dec = self.host.values.decode_batch(
                np.where(vids[sel] == VID_NULL, 0, vids[sel])
            )
            out1: Dict[int, Any] = {}
            for slot, v, d in zip(
                np.asarray(slots)[sel].tolist(), vids[sel].tolist(), dec
            ):
                out1[slot] = None if v == VID_NULL else d
            return out1
        if self.layout in PACKED_FAMILY:
            cls, vid = _gather_entries_packed(self.table, jnp.int32(peer), arr)
        else:
            cls, _khi, _klo, vid, *_ = _gather_entries(
                self.table, jnp.int32(peer), arr
            )
        cls = np.asarray(cls)
        vid = np.asarray(vid)
        sel2 = cls != CLS_ABSENT
        dec2 = self.host.values.decode_batch(
            np.where(vid[sel2] == VID_NULL, 0, vid[sel2])
        )
        out: Dict[int, Any] = {}
        for slot, v, d in zip(
            np.asarray(slots)[sel2].tolist(), vid[sel2].tolist(), dec2
        ):
            out[slot] = None if v == VID_NULL else d
        return out

    def get(self, peer: int, path: str = "") -> Any:
        """Read a value/subtree at ``peer`` (device gather + host tree
        rebuild). Missing paths return None (no auto-vivify in the engine —
        reads are reads). Get hooks may rewrite the path; afterGet hooks may
        rewrite the data (bullet-middleware.js:27-68)."""
        if self.hooks.active:
            path = self.hooks.rewrite_get(peer, path)
            return self.hooks.rewrite_after_get(
                peer, path, self._get_raw(peer, path)
            )
        return self._get_raw(peer, path)

    def get_bulk(self, peers, paths) -> List[Any]:
        """Batched point reads — the read twin of ``put_bulk``: ONE device
        gather for all K (peer, path) pairs, then a columnar host decode
        (unique vids decode once). ``peers`` is an int array [K] or a
        single int broadcast over all paths; ``paths`` is a list of K path
        strings or an int32 array of pre-interned slot ids. Returns K leaf
        values (None for null, absent, unknown, or interior paths — use
        ``get`` for subtree materialization). Get hooks (path rewrite +
        afterGet data rewrite) apply per pair when registered."""
        if isinstance(paths, np.ndarray) and paths.dtype.kind == "i":
            slots = paths.astype(np.int32)
            valid = slots >= 0
            path_strs = None
        else:
            paths = list(paths)
            if self.hooks.active:
                prow = np.broadcast_to(
                    np.asarray(peers, dtype=np.int32), (len(paths),)
                )
                paths = [
                    self.hooks.rewrite_get(int(pr), p)
                    for pr, p in zip(prow, paths)
                ]
            # one batch lookup (native: one C call) — the K-ctypes-call
            # loop here was ~80% of get_bulk wall time at 100k reads
            slots = self.host.paths.lookup_batch(paths)
            valid = slots >= 0
            slots = np.where(valid, slots, 0).astype(np.int32)
            path_strs = paths
        k = len(slots)
        peers_arr = np.broadcast_to(
            np.asarray(peers, dtype=np.int32), (k,)
        ).astype(np.int32)
        self._sync_device_state()
        if self.layout == "rank1":
            ranks = np.asarray(_gather_ranks_pairs(
                self.table, jnp.asarray(peers_arr), jnp.asarray(slots)
            ))
            vid = self.rank_index.decode_ranks(ranks)
            present = valid & (vid >= 0) & (vid != VID_NULL)
        else:
            gather = (
                _gather_pairs_packed
                if self.layout in PACKED_FAMILY else _gather_pairs
            )
            cls, vid = gather(
                self.table, jnp.asarray(peers_arr), jnp.asarray(slots)
            )
            cls = np.asarray(cls)
            vid = np.asarray(vid)
            present = valid & (cls != CLS_ABSENT) & (vid != VID_NULL)
        out_arr = np.full(k, None, dtype=object)
        if present.any():
            uniq, inverse = np.unique(vid[present], return_inverse=True)
            decoded = self.host.values.decode_batch(uniq)
            out_arr[present] = decoded[inverse]
        out: List[Any] = out_arr.tolist()
        if self.hooks.active and path_strs is not None:
            out = [
                self.hooks.rewrite_after_get(int(pr), p, v)
                for pr, p, v in zip(peers_arr, path_strs, out)
            ]
        return out

    def _get_raw(self, peer: int, path: str = "") -> Any:
        if path:
            pid = self.host.paths.lookup(path)
            if pid is None:
                return None
            slots = [pid, *self.host.leaf_slots_under(pid)]
            values = self._decode_slots(peer, slots)
            tree = self.host.build_tree(pid, values)
            return None if tree is MISSING else tree
        roots = self.host.paths.top_level()
        all_slots = list(range(len(self.host.paths)))
        values = self._decode_slots(peer, all_slots)
        out = {}
        for r in roots:
            sub = self.host.build_tree(r, values)
            if sub is not MISSING:
                out[self.host.paths.segment(r)] = sub
        return out

    # --------------------------------------------------------------- queries

    def _mask_paths_row(self, row_mask, parents: bool = False) -> List[str]:
        """Materialize a device hit mask into sorted path strings in one
        batched pass (no per-hit Python path()/parent() calls —
        VERDICT r3 weak #5). ``parents=True`` maps each hit to its parent
        path (the field-variant result shape, matching the reference's
        node-path results, bullet-query.js:202-209)."""
        hits = np.nonzero(np.asarray(row_mask))[0]
        if parents:
            hits = self.host.paths.parents_batch(hits)
        return sorted(self.host.paths.paths_batch(hits))

    def equals(self, peer: int, base: str, field: Optional[str], value: Any = MISSING):
        """Vectorized equals scan (reference: bullet-query.js:186-210)."""
        if value is MISSING:
            field, value = None, field
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return []
        _, _, _, vid = self.host.encode_value(value)
        self._sync_device_state()
        struct = self.host.struct()
        if self.layout == "rank1":
            # rank-native equals: value identity ≡ ONE rank compare (ranks
            # are a bijection over vids) — no RowView rebuild, no gathers
            rank = self._probe_rank(vid)
            if rank == 0:
                return []  # value never ranked ⇒ never applied anywhere
            rank_row = self.table.rank[jnp.int32(peer)]
            if field is not None:
                fid = self.host.seg_lookup(field)
                if fid < 0:
                    return []
                mask = scans.equals_field_mask_rank(
                    rank_row, struct, jnp.int32(base_pid), jnp.int32(fid),
                    jnp.int32(rank),
                )
                return self._mask_paths_row(mask, parents=True)
            mask = scans.equals_leaf_mask_rank(
                rank_row, struct, jnp.int32(base_pid), jnp.int32(rank)
            )
            return self._mask_paths_row(mask)
        row = self._peer_row(peer)
        if field is not None:
            fid = self.host.seg_lookup(field)
            if fid < 0:
                return []
            mask = scans.equals_field_mask_row(
                row, struct, jnp.int32(base_pid), jnp.int32(fid), jnp.int32(vid)
            )
            return self._mask_paths_row(mask, parents=True)
        mask = scans.equals_leaf_mask_row(
            row, struct, jnp.int32(base_pid), jnp.int32(vid)
        )
        return self._mask_paths_row(mask)

    def _probe_rank(self, vid: int) -> int:
        """The query-probe rank for a vid (rank1): 0 if the vid was never
        ranked — i.e. the value was never applied on any peer, so an
        equality scan cannot match (live table ranks are ≥ 1). O(1): no
        rank_map() copy (that LUT is O(#interned values))."""
        if vid < len(self.rank_index._rank_of):
            return self.rank_index.rank_of(vid)
        return 0

    def range(self, peer: int, base: str, field, lo=MISSING, hi=MISSING):
        """Vectorized numeric range scan (reference: bullet-query.js:221-261)."""
        if hi is MISSING:
            field, lo, hi = None, field, lo
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return []
        from ..utils.encode import number_key

        lo_hi, lo_lo = number_key(float(lo))
        hi_hi, hi_lo = number_key(float(hi))
        self._sync_device_state()
        struct = self.host.struct()
        if self.layout == "rank1":
            # rank-native range: keys in [lo, hi] within the number class
            # form ONE contiguous rank run (ranks are lexicographic in
            # (cls, khi, klo, vid)); the host computes the run's bounds
            from ..utils.encode import CLS_NUMBER

            bounds = self.rank_index.rank_bounds(
                CLS_NUMBER, lo_hi, lo_lo, hi_hi, hi_lo
            )
            if bounds is None:
                return []
            lo_rank, hi_rank = bounds
            rank_row = self.table.rank[jnp.int32(peer)]
            if field is not None:
                fid = self.host.seg_lookup(field)
                if fid < 0:
                    return []
                mask = scans.range_field_mask_rank(
                    rank_row, struct, jnp.int32(base_pid), jnp.int32(fid),
                    jnp.int32(lo_rank), jnp.int32(hi_rank),
                )
                return self._mask_paths_row(mask, parents=True)
            mask = scans.range_leaf_mask_rank(
                rank_row, struct, jnp.int32(base_pid),
                jnp.int32(lo_rank), jnp.int32(hi_rank),
            )
            return self._mask_paths_row(mask)
        args = (
            jnp.int32(lo_hi),
            jnp.int32(lo_lo),
            jnp.int32(hi_hi),
            jnp.int32(hi_lo),
        )
        row = self._peer_row(peer)
        if field is not None:
            fid = self.host.seg_lookup(field)
            if fid < 0:
                return []
            mask = scans.range_field_mask_row(
                row, struct, jnp.int32(base_pid), jnp.int32(fid), *args
            )
            return self._mask_paths_row(mask, parents=True)
        mask = scans.range_leaf_mask_row(row, struct, jnp.int32(base_pid), *args)
        return self._mask_paths_row(mask)

    def count(self, peer: int, base: str, field, value: Any = MISSING) -> int:
        """Device-side match count (reference: bullet-query.js:293-313) —
        the fused mask+sum program returns ONE scalar, skipping the [N]
        mask readback and host path reconstruction ``equals`` pays.
        Accepts a traced Predicate in place of (field, value)."""
        from ..ops.predicates import Predicate

        if isinstance(field, Predicate):
            res = self._predicate_mask(peer, base, field)
            return 0 if res is None else int(res[1])
        if value is MISSING:
            field, value = None, field
        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return 0
        _, _, _, vid = self.host.encode_value(value)
        self._sync_device_state()
        struct = self.host.struct()
        if self.layout == "rank1":
            rank = self._probe_rank(vid)
            if rank == 0:
                return 0
            rank_row = self.table.rank[jnp.int32(peer)]
            if field is not None:
                fid = self.host.seg_lookup(field)
                if fid < 0:
                    return 0
                return int(scans.equals_field_count_rank(
                    rank_row, struct, jnp.int32(base_pid), jnp.int32(fid),
                    jnp.int32(rank)
                ))
            return int(scans.equals_leaf_count_rank(
                rank_row, struct, jnp.int32(base_pid), jnp.int32(rank)
            ))
        row = self._peer_row(peer)
        if field is not None:
            fid = self.host.seg_lookup(field)
            if fid < 0:
                return 0
            return int(scans.equals_field_count_row(
                row, struct, jnp.int32(base_pid), jnp.int32(fid),
                jnp.int32(vid)
            ))
        return int(scans.equals_leaf_count_row(
            row, struct, jnp.int32(base_pid), jnp.int32(vid)
        ))

    def filter(self, peer: int, base: str, fn) -> List[str]:
        """Child scan with a predicate (reference: bullet-query.js:270-283).

        ``fn`` may be a traced :class:`~bullet_tpu.ops.predicates.Predicate`
        (``P["age"] > 25``) — evaluated entirely on device as one compiled
        mask program, never decoding the subtree to host — or an arbitrary
        Python callable (host fallback: decode + scan)."""
        from ..ops.predicates import Predicate

        if isinstance(fn, Predicate):
            mask = self._predicate_mask(peer, base, fn)
            return [] if mask is None else self._mask_paths_row(mask[0])
        data = self.get(peer, base)
        if not isinstance(data, dict):
            return []
        return sorted(
            f"{base}/{key}" for key, value in data.items() if _pred(fn, value, key)
        )

    def _predicate_mask(self, peer: int, base: str, pred):
        """(mask [N] bool over path ids, count i32) for a traced predicate;
        None when ``base`` was never interned."""
        from ..ops.predicates import compile_predicate, predicate_params

        base_pid = self.host.paths.lookup(base)
        if base_pid is None:
            return None
        # resolve probe values BEFORE the device sync: encoding may intern
        # new values / re-key strings (same ordering equals() uses)
        params = predicate_params(
            pred, self.host.seg_lookup, self.host.encode_value
        )
        self._sync_device_state()
        row = self._peer_row(peer)
        struct = self.host.struct()
        fn = compile_predicate(pred)
        return fn(
            row, struct, jnp.int32(base_pid),
            jnp.asarray(params, dtype=jnp.int32),
        )

    def find(self, peer: int, base: str, fn) -> Optional[str]:
        from ..ops.predicates import Predicate

        if isinstance(fn, Predicate):
            hits = self.filter(peer, base, fn)
            return hits[0] if hits else None
        data = self.get(peer, base)
        if isinstance(data, dict):
            for key, value in data.items():
                if _pred(fn, value, key):
                    return f"{base}/{key}"
        return None

    def map(self, peer: int, base: str, fn: Callable) -> List[Any]:
        data = self.get(peer, base)
        if not isinstance(data, dict):
            return []
        return [_pred(fn, value, key) for key, value in data.items()]

    # ------------------------------------------- facade: validation + hooks

    def define_schema(self, name: str, schema: dict) -> "PeerNetworkSim":
        """Register a named schema (reference: bullet-validation.js:54-63)."""
        self.validation.define_schema(name, schema)
        return self

    def apply_schema(self, base_path: str, schema_name: str) -> "PeerNetworkSim":
        """Bind a schema to a base path; writes under it validate at batch
        ingress — host typed checks for ``put``, compiled device masks for
        bulk batches (the north star's trace-time validation)."""
        self.validation.apply_schema(base_path, schema_name)
        return self

    def remove_schema(self, base_path: str) -> "PeerNetworkSim":
        self.validation.remove_schema(base_path)
        return self

    def on_validation_error(self, error_type: str, handler) -> "PeerNetworkSim":
        self.validation.on_error(error_type, handler)
        return self

    def validate(self, schema_name: str, data: Any) -> bool:
        return self.validation.validate(schema_name, data)

    def use(self, operation: str, fn: Callable) -> "PeerNetworkSim":
        """Register a middleware hook (put/afterPut/get/afterGet/delete/
        afterDelete — reference: bullet-middleware.js:198-209)."""
        self.hooks.use(operation, fn)
        return self

    def use_traced_put(self, fn: Callable) -> "PeerNetworkSim":
        """Register a pure OpBatch transform traced into the jitted step."""
        self.hooks.use_traced_put(fn)
        return self

    def on_event(self, event: str, listener: Callable) -> "PeerNetworkSim":
        """Subscribe to engine events ("write", "read", "delete", "error",
        "all" — reference: bullet-middleware.js:278-313)."""
        self.hooks.on_event(event, listener)
        return self

    # -------------------------------------------------- facade: serialization

    def _scratch_bullet(self, peer: Optional[int] = None):
        """Throwaway storage-less Bullet; seeded with ``peer``'s replica when
        given (the serializer operates on a Bullet store)."""
        import bullet_tpu as bt

        b = bt.create({"storage": False, "disable_network": True})
        if peer is not None:
            from .bridge import dump_sim_into_bullet

            dump_sim_into_bullet(self, b, peer=peer)
        return b

    def export_to_json(self, peer: int, path: str = "", options=None) -> str:
        """Serialize a peer's replica (reference formats, bullet-serializer.js
        envelope) by materializing it through the db layer."""
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_json(path, options)
        finally:
            b.close()

    def export_to_csv(self, peer: int, path: str, options=None) -> str:
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_csv(path, options)
        finally:
            b.close()

    def export_to_xml(self, peer: int, path: str, options=None) -> str:
        b = self._scratch_bullet(peer)
        try:
            return b.export_to_xml(path, options)
        finally:
            b.close()

    def _import_via_bullet(self, peer: int, importer) -> dict:
        b = self._scratch_bullet()
        try:
            result = importer(b)
            if result.get("success"):
                from .bridge import load_bullet_into_sim

                load_bullet_into_sim(b, self, peer=peer)
            return result
        finally:
            b.close()

    def import_from_json(self, peer: int, json_str: str, target_path=None,
                         options=None) -> dict:
        """Parse reference-format JSON and enqueue its leaves as puts at
        ``peer`` (step/run_until_converged applies them)."""
        return self._import_via_bullet(
            peer, lambda b: b.import_from_json(json_str, target_path, options)
        )

    def import_from_csv(self, peer: int, csv_str: str, target_path: str,
                        options=None) -> dict:
        return self._import_via_bullet(
            peer, lambda b: b.import_from_csv(csv_str, target_path, options)
        )

    def import_from_xml(self, peer: int, xml_str: str, target_path: str,
                        options=None) -> dict:
        return self._import_via_bullet(
            peer, lambda b: b.import_from_xml(xml_str, target_path, options)
        )

    # ---------------------------------------------------------- subscriptions

    def peer(self, index: int):
        """Peer-scoped fluent view: ``sim.peer(3).get("users/a").put(...)``."""
        from .node import SimPeer

        return SimPeer(self, index)

    def off(self, peer: int, path: str, callback: Optional[Callable] = None) -> None:
        """Unsubscribe (reference BulletNode.off, bullet.js:737-749)."""
        self._subs = [
            s
            for s in self._subs
            if not (
                s["peer"] == peer
                and s["path"] == path
                and (callback is None or s["callback"] is callback)
            )
        ]
        self._watch_dirty = True

    def save_checkpoint(self, directory: str, backend: str = "npz") -> None:
        from .checkpoint import save_checkpoint

        save_checkpoint(self, directory, backend=backend)

    @staticmethod
    def load_checkpoint(directory: str, mesh_devices: Optional[int] = None):
        from .checkpoint import load_checkpoint

        return load_checkpoint(directory, mesh_devices)

    def on(self, peer: int, path: str, callback: Callable[[Any], None]) -> None:
        """Subscribe to a path at a peer; fires immediately with the current
        value (reference BulletNode.on, bullet.js:710-720) and after any step
        that changes it (ancestor bubbling falls out: a subtree read changes
        when any descendant leaf changes)."""
        self.host.intern_path(path)
        current = self.get(peer, path)
        callback(current)
        self._subs.append(
            {"peer": peer, "path": path, "callback": callback, "last": current}
        )
        self._watch_dirty = True

    # -- changed-slot dispatch ------------------------------------------
    # Re-reading every watched subtree after every step is O(subs x subtree)
    # host work (each read is a device gather + tree rebuild). Instead ONE
    # jit gather pulls the (cls, vid) of every watched slot, a numpy compare
    # against the previous snapshot yields the set of subscriptions whose
    # slots actually changed, and only THOSE re-read their subtree --
    # O(watched) device work per step, O(changed) host dispatch
    # (reference notify semantics preserved: bullet.js:227-266).

    def _build_watch_index(self) -> None:
        peers, slots, sub_of = [], [], []
        for si, sub in enumerate(self._subs):
            pid = self.host.paths.lookup(sub["path"]) if sub["path"] else None
            if sub["path"]:
                watch = ([pid, *self.host.leaf_slots_under(pid)]
                         if pid is not None else [])
            else:  # root watch: every slot
                watch = list(range(len(self.host.paths)))
            for s in watch:
                peers.append(sub["peer"])
                slots.append(s)
                sub_of.append(si)
        self._watch_peers = np.asarray(peers, dtype=np.int32)
        self._watch_slots = np.asarray(slots, dtype=np.int32)
        self._watch_subof = np.asarray(sub_of, dtype=np.int64)
        self._watch_paths_len = len(self.host.paths)
        self._watch_dirty = False
        self._watch_prev = None  # unknown baseline: check every sub once

    def _gather_watch_values(self):
        if len(self._watch_peers) == 0:
            return np.empty((0,), dtype=np.int64)
        peers = jnp.asarray(self._watch_peers)
        slots = jnp.asarray(self._watch_slots)
        if self.layout == "rank1":
            # the rank IS the entry (bijection), so rank diffs ≡ cv diffs
            # within one epoch; a respread re-ranks everything and fires
            # one spurious diff pass, which _fire_subscriptions absorbs
            # (callbacks only fire when the materialized value changed)
            rank = _gather_ranks_pairs(self.table, peers, slots)
            return np.asarray(rank, dtype=np.int64)
        if self.layout in PACKED_FAMILY:
            cv = _gather_watch_packed(self.table, peers, slots)
            return np.asarray(cv, dtype=np.int64)
        cls, vid = _gather_watch_dense(self.table, peers, slots)
        return (np.asarray(cls, dtype=np.int64) << 32) | np.asarray(
            vid, dtype=np.int64
        )

    def _fire_subscriptions(self) -> None:
        if not self._subs:
            return
        self._sync_device_state()
        if (
            getattr(self, "_watch_dirty", True)
            or self._watch_paths_len != len(self.host.paths)
        ):
            self._build_watch_index()
        values = self._gather_watch_values()
        if self._watch_prev is None:
            changed_subs = range(len(self._subs))
        else:
            diff = values != self._watch_prev
            changed_subs = np.unique(self._watch_subof[diff]).tolist()
        self._watch_prev = values
        for si in changed_subs:
            sub = self._subs[si]
            value = self.get(sub["peer"], sub["path"])
            if value != sub["last"]:
                sub["last"] = value
                try:
                    sub["callback"](value)
                except Exception:  # noqa: BLE001 - listener isolation
                    pass

    # ------------------------------------------------------------- lifecycle

    def snapshot(self) -> dict:
        """Host checkpoint of device state (the engine's storage adapter).

        Pending puts are FLUSHED (applied) first, exactly like
        save_checkpoint: a snapshot must capture every put issued before
        it, or the captured state would depend on whether a step/query
        happened to apply the queue earlier (twin sims that applied at
        different times used to capture diverging snapshots). The
        restore twin of this contract discards the queue instead —
        together they make snapshot→restore a clean timeline cut."""
        if any(self._pending) or self._pending_bulk:
            self.step(rounds=0)
        self._sync_device_state()
        snap = {
            "table": [np.asarray(f) for f in self.table],
            "tick": self.tick,
            "clock": self._clock_snapshot(),
            "capacity": self.capacity,
        }
        if self.layout in RANK_FAMILY:
            # ranks are only meaningful against ONE RankIndex epoch; stamp
            # it so restore can detect a respread between snapshot and
            # restore and re-gather the stale ranks through the fresh LUT
            snap["rank_epoch"] = self.rank_index.epoch
            if self.layout == "rank1":
                # rank1 has no vid column to decode stale ranks through —
                # the snapshot carries its OWN epoch's inverse (tiny: two
                # arrays over the live value count)
                sr, sv = self.rank_index.inverse_arrays()
                snap["rank_inverse"] = (sr.copy(), sv.copy())
        return snap

    def restore(self, snap: dict) -> None:
        """Rewind to EXACTLY the snapshot state. Pending (un-applied)
        puts are DISCARDED: they belong to the abandoned post-snapshot
        timeline, and keeping them would make the restored state depend
        on apply TIMING — a write issued before the restore would
        survive if still queued but vanish if a step/query had already
        applied it (caught by the twin-sim soak, where one sim's
        apply-refreshing view made restores diverge)."""
        for ops in self._pending:
            ops.clear()
        self._pending_bulk.clear()
        if self.layout in RANK_FAMILY:
            # bring the index current BEFORE swapping tables: a pending
            # insert could respread and re-key the live table, and for
            # rank1 that re-key decodes through prev_inverse — which only
            # matches the CURRENT table's epoch, not the snapshot's
            self._sync_rank_index()
        # on a mesh each field goes straight to its shards, never whole
        # onto one device
        put = jnp.asarray if self.mesh is None else functools.partial(
            jax.device_put, device=peer_sharding(self.mesh))
        self.table = type(self.table)(*(put(f) for f in snap["table"]))
        if self.layout in RANK_FAMILY and snap.get("rank_epoch") != (
            self.rank_index.epoch
        ):
            from ..ops.rank import rekey_rank, rekey_rank1

            if self.layout == "rank1":
                osr, osv = snap["rank_inverse"]
                if len(osr):  # empty inverse ⇔ all-absent snapshot table
                    self.table = rekey_rank1(
                        self.table, jnp.asarray(osr), jnp.asarray(osv),
                        jnp.asarray(self.rank_index.rank_map()),
                    )
            else:
                self.table = rekey_rank(
                    self.table, jnp.asarray(self.rank_index.rank_map())
                )
        if self.mesh is not None:
            self.table = shard_table(self.table, self.mesh)
        self.tick = snap["tick"]
        self._clock = snap["clock"].copy()
        self._clock_list = self._clock.tolist()
        self.capacity = snap["capacity"]

    def tables_equal(self) -> bool:
        """All peers bit-identical (the convergence acceptance check).
        Computed on-device — only one scalar crosses to the host."""
        if self.layout in PACKED_FAMILY:
            # compare ONE field in ONE fused jit (module-level: the jit
            # cache must hit across calls) — eager &/>> would each
            # allocate a table-sized temp. cv equal ⇔ (cls, vid) equal; for rank1 the
            # rank is a bijection over entries so rank equal ⇔ entry equal
            field = (
                self.table.rank if self.layout == "rank1" else self.table.cv
            )
            return bool(_rows_equal_one(field))
        return bool(_rows_equal_two(self.table.vid, self.table.cls))

    def _peer_row(self, peer: int) -> scans.RowView:
        """One replica row as a query RowView, layout-independent."""
        if self.layout == "packed":
            return _peer_row_packed(self.table, jnp.int32(peer))
        if self.layout == "rank":
            _c, khi_map, klo_map = self.host.key_tables()
            return _peer_row_rank(
                self.table, jnp.int32(peer),
                jnp.asarray(khi_map), jnp.asarray(klo_map),
            )
        if self.layout == "rank1":
            if len(self.rank_index) == 0:
                # nothing ranked ⇒ nothing on device: an all-absent view
                z = jnp.zeros_like(self.table.rank[peer])
                return scans.RowView(cls=z, khi=z, klo=z, vid=z)
            cls_map, khi_map, klo_map = self.host.key_tables()
            sranks, svids = self.rank_index.inverse_arrays()
            return _peer_row_rank1(
                self.table, jnp.int32(peer),
                jnp.asarray(sranks), jnp.asarray(svids),
                jnp.asarray(cls_map), jnp.asarray(khi_map),
                jnp.asarray(klo_map),
            )
        return scans.peer_row(self.table, jnp.int32(peer))


def _pred(fn, value, key):
    try:
        return fn(value, key)
    except TypeError:
        return fn(value)
