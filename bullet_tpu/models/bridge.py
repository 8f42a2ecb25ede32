"""Bridge between the db layer and the engine.

Lets reference-style users move data between a live ``Bullet`` instance
(single process, real networking) and a ``PeerNetworkSim`` (thousands of
simulated peers): seed a simulation from production state, or materialize a
converged replica back into a database.
"""

from __future__ import annotations

from typing import Optional

from .table import MISSING, flatten_value  # sims' sentinel + leaf decomposition


def load_bullet_into_sim(bullet, sim, peer: int = 0) -> int:
    """Enqueue every leaf of a Bullet store as local puts at ``peer``.

    Uses the same recursive leaf decomposition as the sync wire format
    (/root/reference/src/bullet-network-sync.js:592-646). Returns the number
    of leaves queued (call ``sim.step()``/``run_until_converged`` after).

    Leaves load through ONE ``put_bulk`` call (paths are unique per
    traversal, so batch lattice reduction can't reorder winners), which
    keeps big production stores at bulk-ingest rates instead of per-leaf
    Python; the converged state is identical to per-leaf scalar puts
    (pinned by test)."""
    paths: list = []
    values: list = []

    def traverse(obj, prefix: str):
        if not isinstance(obj, dict):
            paths.append(prefix)
            values.append(obj)
            return
        for key, value in obj.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                traverse(value, path)
            else:
                paths.append(path)
                values.append(value)

    traverse(bullet.store, "")
    if paths:
        sim.put_bulk(peer, paths, values)
    return len(paths)


def dump_sim_into_bullet(sim, bullet, peer: int = 0, broadcast: bool = False) -> int:
    """Write a peer's converged replica into a Bullet instance through its
    normal write path (CRT, validation, middleware and indexes all apply).
    Returns the number of leaves written."""
    count = 0
    values = sim._decode_slots(peer, list(range(len(sim.host.paths))))
    for slot, value in values.items():
        bullet.set_data(sim.host.paths.path(slot), value, broadcast=broadcast)
        count += 1
    return count


def sim_from_bullet(
    bullet,
    num_peers: int,
    topology="ring",
    mode: str = "reference",
    mesh_devices: Optional[int] = None,
):
    """Create a converged sim seeded with a Bullet instance's state."""
    from .netsim import PeerNetworkSim

    leaves = _count_leaves(bullet.store)
    capacity = max(128, 2 * leaves)
    sim = PeerNetworkSim(
        num_peers,
        capacity=capacity,
        topology=topology,
        mode=mode,
        mesh_devices=mesh_devices,
    )
    load_bullet_into_sim(bullet, sim, peer=0)
    sim.run_until_converged()
    return sim


def _count_leaves(obj) -> int:
    if not isinstance(obj, dict):
        return 1
    return sum(_count_leaves(v) for v in obj.values()) or 0


class ReplicaView:
    """Read-only query facade bound to ONE peer's replica — the serving
    surface for a mirrored (or any) sim peer: every sim query method
    minus the peer argument, with NO write methods, so it can be handed
    to request handlers without exposing the simulation.

    ``refresh`` controls staleness per query:
    - ``"apply"`` (default): fold queued writes into the device table
      first (apply-only, no gossip — the bound peer's own row is current
      the moment its ops land, which is exactly the live-bridge mirror
      case where every write targets this peer);
    - ``"converge"``: gossip to the fixed point first (multi-writer
      bridges, where OTHER peers' rows carry the missing writes);
    - ``None``: serve the last applied state as-is (refresh overhead
      only, not zero: the query itself still serializes).

    Thread-safety: pass the owning bridge's lock (``attach_live_bridge``
    wires its own). The lock is held across the WHOLE query, refresh
    included — reads mutate sim state (capacity growth, re-keying, and
    on rank1 the decode must use the RankIndex inverse of the same
    epoch as the ranks it reads), so a query racing a mirror put could
    otherwise re-key the table mid-put or decode ranks through a newer
    epoch's inverse."""

    def __init__(self, sim, peer: int = 0, refresh: str = "apply",
                 lock=None, pump=None) -> None:
        if refresh not in ("apply", "converge", None):
            raise ValueError(f"unknown refresh policy: {refresh!r}")
        import threading

        self._sim = sim
        self._peer = peer
        self._refresh = refresh
        self._lock = lock if lock is not None else threading.Lock()
        self._pump = pump

    def _refresh_locked(self):
        if self._pump is not None and self._refresh is not None:
            self._pump()  # drain the bridge's staged writes (one put_bulk)
        if self._refresh == "apply":
            self._sim.step(rounds=0)
        elif self._refresh == "converge":
            self._sim.run_until_converged()

    def get(self, path: str = ""):
        with self._lock:
            self._refresh_locked()
            return self._sim.get(self._peer, path)

    def equals(self, base: str, field, value=MISSING):
        with self._lock:
            self._refresh_locked()
            return self._sim.equals(self._peer, base, field, value)

    def range(self, base: str, field, lo=MISSING, hi=MISSING):
        with self._lock:
            self._refresh_locked()
            return self._sim.range(self._peer, base, field, lo, hi)

    def count(self, base: str, field, value=MISSING) -> int:
        with self._lock:
            self._refresh_locked()
            return self._sim.count(self._peer, base, field, value)

    def filter(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.filter(self._peer, base, fn)

    def find(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.find(self._peer, base, fn)

    def map(self, base: str, fn):
        with self._lock:
            self._refresh_locked()
            return self._sim.map(self._peer, base, fn)


def attach_live_bridge(bullet, sim, peer: int = 0):
    """Stream every ACCEPTED write on a live Bullet instance — local puts
    AND network-applied updates (flood or sync) — into the engine as leaf
    puts at ``peer``. The hook rides ``_apply_update`` (the single point
    every resolved write passes through, twin of bullet.js:184-220), so
    the engine mirror follows the db's post-CRT state: a wire-connected
    peer (bullet-js interop included) becomes a device-resident replica.

    Semantics: dict values decompose into leaf puts like the sync wire
    format (bullet-network-sync.js:592-646) — the mirror is leaf-merge,
    not subtree-replace, exactly like remote sync application. Call
    ``sim.step(rounds=0)`` / ``run_until_converged()`` (or the returned
    handle's ``flush()``) to apply queued mirror writes on device.

    Contract: the mirror applies the db's RESOLVED values under the
    engine's reference-mode order (value-max — the Node reference's
    converged scalar semantics). The one flow where db state and mirror
    can differ is a clock-DOMINANT update that regresses a path to a
    smaller value (possible after an anti-entropy clock exchange): the
    db replaces, the mirror keeps the larger value until something
    greater lands. Concurrent-clock traffic — the steady state of flood
    networks — resolves by value on both sides and stays identical.

    Returns a handle with ``detach()`` (restore the original hook),
    ``flush()`` (apply + converge), and ``view(refresh="apply")`` — a
    read-only ``ReplicaView`` bound to the mirror peer for serving
    queries without exposing the simulation (the default apply-only
    refresh is exact here: every mirror write targets this peer's own
    row, so no gossip is needed to see it). Thread-safe: network reader
    threads and the app thread both hit the forwarder.

    Bridges STACK (each wraps the current ``_apply_update``, so one db
    can mirror into several sims); detach in REVERSE attach order — an
    out-of-order detach restores ITS captured predecessor, silently
    re-installing an already-detached forwarder above it.

    Serving tail latency: the forwarder takes NO lock — it appends the
    accepted (path, value) to a staging deque (GIL-atomic). A hot write
    loop acquiring a lock ~30k times/s convoys any thread waiting on
    that lock for hundreds of ms (the r3 serving bench's p95 ≈ 0.6 s was
    exactly this, not device work); staging decouples the wire thread
    from queries entirely. Queries (and ``flush()``) drain the stages
    under the sim's bridge lock in bulk ``put_bulk`` calls — batched
    encode instead of per-op Python — then fold as before, so
    ``refresh="apply"`` still reads every write accepted before the
    query began. Anything reading ``sim`` directly (not through the
    view/handle) should call ``pump()`` first to fold staged writes in.

    Multi-bridge fabric: the lock AND the stage registry live on the
    SIM (one per sim, shared by every attached bridge), so any handle's
    ``pump()``/``flush()``/view query drains EVERY bridge's staged
    writes before folding/converging — ``ha.flush()`` sees peer b's
    mirror stream too, and two bridges can never race ``put_bulk`` on
    the same sim under different locks."""
    from collections import deque

    orig = bullet._apply_update
    lock = sim._bridge_lock
    staged: deque = deque()
    stage_entry = (staged, peer)
    sim._bridge_stages.append(stage_entry)

    def forward(path, value, vector_clock, from_network):
        orig(path, value, vector_clock, from_network)
        staged.append((path, value))

    bullet._apply_update = forward

    def pump_locked() -> int:
        """Drain EVERY attached bridge's staged writes into the sim queue
        as bulk puts (same leaf decomposition as load_bullet_into_sim /
        the sync wire format, bullet-network-sync.js:592-646). Caller
        must hold ``sim._bridge_lock``."""
        total = 0
        for stage, stage_peer in list(sim._bridge_stages):
            if not stage:
                continue
            paths: list = []
            values: list = []
            # bound by the snapshot length: appends racing the drain are
            # the NEXT pump's work, so a sustained flood can't pin us
            for _ in range(len(stage)):
                try:
                    path, value = stage.popleft()
                except IndexError:  # racing pump drained it first
                    break
                for leaf_path, leaf_value in flatten_value(path, value):
                    paths.append(leaf_path)
                    values.append(leaf_value)
            if paths:
                sim.put_bulk(stage_peer, paths, values)
                total += len(paths)
        return total

    class _Handle:
        def detach(self) -> None:
            bullet._apply_update = orig
            with lock:
                # staged-but-unpumped writes are accepted db state — fold
                # this bridge's remainder in rather than dropping it
                if staged:
                    paths: list = []
                    values: list = []
                    while staged:
                        path, value = staged.popleft()
                        for lp, lv in flatten_value(path, value):
                            paths.append(lp)
                            values.append(lv)
                    if paths:
                        sim.put_bulk(peer, paths, values)
                try:
                    sim._bridge_stages.remove(stage_entry)
                except ValueError:
                    pass  # already detached

        def pump(self) -> int:
            """Move staged mirror writes (ALL attached bridges) into the
            sim queue (no gossip)."""
            with lock:
                return pump_locked()

        def backlog(self) -> int:
            """This bridge's staged writes not yet pumped (monitoring)."""
            return len(staged)

        def flush(self) -> int:
            with lock:
                pump_locked()
                return sim.run_until_converged()

        def view(self, refresh: str = "apply") -> ReplicaView:
            return ReplicaView(
                sim, peer, refresh=refresh, lock=lock, pump=pump_locked
            )

    return _Handle()
