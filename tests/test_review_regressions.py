"""Regression tests for the code-review findings (each pinned a real bug)."""

import numpy as np

import bullet_tpu as bt
from bullet_tpu.models.netsim import PeerNetworkSim


def test_network_writes_pass_strict_validation(bullet_factory):
    """Wire markers (__fromNetwork/__vectorClock) must not trip strict
    schemas — they're transport framing, not user data."""
    b = bullet_factory()
    b.define_schema(
        "cfg",
        {
            "type": "object",
            "additionalProperties": False,
            "properties": {"name": {"type": "string"}},
        },
    )
    b.apply_schema("config", "cfg")
    b.set_data(
        "config",
        {"name": "remote", "__fromNetwork": True, "__vectorClock": {"peer": 3}},
        broadcast=False,
    )
    assert b.store.get("config", {}).get("name") == "remote"
    # genuinely unknown properties still blocked
    b.set_data("config", {"name": "x", "evil": 1}, broadcast=False)
    assert "evil" not in (b.store.get("config") or {})


def test_strict_collection_schema_accepts_members(bullet_factory):
    """additionalProperties:false governs member contents, not member ids."""
    b = bullet_factory()
    b.define_schema(
        "user",
        {
            "type": "object",
            "additionalProperties": False,
            "properties": {"name": {"type": "string"}},
        },
    )
    b.apply_schema("users", "user")
    b.get("users/u1").put({"name": "alice"})
    assert b.get("users/u1").value() == {"name": "alice"}
    b.get("users/u2").put({"name": "bob", "extra": 1})
    assert b.store.get("users", {}).get("u2") is None


def test_sync_resume_ack_does_not_complete():
    """A sync-response carrying resuming:true must not finish the sync (it
    would advance `since` past the missing chunks forever)."""
    from bullet_tpu.db.sync import BulletNetworkSync

    class FakeNetwork:
        def __init__(self):
            self.peers = {}
            self.sent = []
            self._listeners = {}

        def on(self, event, fn):
            self._listeners.setdefault(event, []).append(fn)

        def emit(self, event, *a):
            for fn in self._listeners.get(event, ()):
                fn(*a)

        def send_to_peer(self, pid, msg):
            self.sent.append((pid, msg))
            return True

    class FakeBullet:
        store = {}
        meta = {}

        def _get_data(self, p):
            return None

        def set_data(self, *a, **k):
            pass

    net = FakeNetwork()
    sync = BulletNetworkSync(FakeBullet(), net, {"sync_interval": 9999})
    try:
        sync.request_sync("peerX")
        req_id = net.sent[-1][1]["id"]
        state = sync._peer_state("peerX")
        assert state["status"] == "requested"
        sync._handle_sync_response(
            "peerX", {"requestId": req_id, "resuming": True, "missingChunks": 3}
        )
        assert state["status"] == "requested"  # NOT complete
        assert state["last_sync_time_ms"] == 0  # since not advanced
    finally:
        sync.close()


def test_on_after_intern_fires_none_not_clamped_value():
    """Subscribing to a brand-new path past capacity must not gather a
    clamped neighbor slot."""
    sim = PeerNetworkSim(2, capacity=8, topology="ring")
    for i in range(8):
        sim.put(0, f"k{i}", 100 + i)
    sim.run_until_converged()
    seen = []
    sim.on(0, "brand/new/path", seen.append)
    assert seen == [None]


def test_query_after_intern_growth():
    """equals() immediately after interning past capacity must not raise a
    struct/table shape mismatch."""
    sim = PeerNetworkSim(2, capacity=8, topology="ring")
    for i in range(7):
        sim.put(0, f"k{i}", i)
    sim.run_until_converged()
    sim.put(0, "users/u1/age", 30)  # interns past capacity, not yet stepped
    assert sim.equals(0, "users", "age", 30) == []
    sim.run_until_converged()
    assert sim.equals(0, "users", "age", 30) == ["users/u1"]


def test_simpeer_equals_none_value():
    """Three-arg equals with value=None must query for null, not degrade to
    the two-arg leaf form."""
    sim = PeerNetworkSim(2, capacity=64, topology="mesh")
    sim.put(0, "users/u1", {"age": None, "name": "x"})
    sim.put(0, "users/u2", {"age": 30, "name": "y"})
    sim.run_until_converged()
    assert sim.peer(1).equals("users", "age", None) == ["users/u1"]


def test_file_storage_atexit_unregistered(tmp_path):
    import atexit

    b = bt.create(
        {
            "disable_network": True,
            "storage": True,
            "storage_type": "file",
            "storage_path": str(tmp_path / "s"),
            "save_interval": 0,
        }
    )
    hook = b.storage._exit_save
    b.close()
    # unregistering again is a no-op only if it was removed; atexit has no
    # introspection API, so just verify double-close and re-register safety
    atexit.unregister(hook)


def test_serializer_index_boundary_match(bullet_factory):
    b = bullet_factory()
    b.get("users/u1").put({"age": 1})
    b.get("users_archive/u1").put({"age": 2})
    b.index("users", "age")
    b.index("users_archive", "age")
    import json

    meta = json.loads(b.export_to_json("users"))["metadata"]
    assert "users:age" in meta["indices"]
    assert "users_archive:age" not in meta["indices"]


def test_halo_tiling_odd_shapes_match_xla():
    """Odd peer counts (P=640/680/6 — not multiples of any tile) must merge
    exactly the ring neighbors: the XLA round against a numpy oracle."""
    import jax.numpy as jnp

    from bullet_tpu.ops.merge import TableState
    from bullet_tpu.parallel.gossip import gossip_round_ring

    rng = np.random.default_rng(0)

    def rt(p, n):
        def arr(lo, hi):
            return rng.integers(lo, hi, (p, n), dtype=np.int32)

        return [arr(0, 4), arr(-50, 50), arr(-50, 50), arr(0, 30),
                arr(0, p), arr(0, 9), arr(0, 5)]

    def oracle(fields):
        keys = fields[:6]  # reference priority: cls, khi, klo, vid, writer, ctr

        def merge(a, b, ka, kb):
            gt = np.zeros(ka[0].shape, bool)
            eq = np.ones(ka[0].shape, bool)
            for x, y in zip(ka, kb):
                gt |= eq & (y > x)
                eq &= x == y
            return [np.where(gt, fb, fa) for fa, fb in zip(a, b)], gt.sum()

        up = [np.roll(f, 1, axis=0) for f in fields]
        m1, c1 = merge(fields, up, keys, up[:6])
        down = [np.roll(f, -1, axis=0) for f in fields]
        m2, c2 = merge(m1, down, m1[:6], down[:6])
        return m2, c1 + c2

    for p, n in [(640, 384), (680, 384), (6, 128)]:
        fields = rt(p, n)
        want, cw = oracle(fields)
        got, cg = gossip_round_ring(
            TableState(*(jnp.asarray(f) for f in fields)), "reference")
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert int(cw) == int(cg)


def test_unsupported_shapes_fall_back_to_xla():
    """p not a multiple of 8 runs like any other shape."""
    from bullet_tpu.ops.merge import init_table
    from bullet_tpu.parallel import topology as topo
    from bullet_tpu.parallel.gossip import gossip_round

    t = init_table(6, 128)
    merged, changed = gossip_round(t, topo.ring(6))
    assert merged.cls.shape == (6, 128)
    assert int(changed) == 0


def test_empty_leaf_path_rejected():
    import pytest

    sim = PeerNetworkSim(2, capacity=16, topology="ring")
    with pytest.raises(ValueError):
        sim.put(0, "", 5)


def test_bridge_tiny_peer_counts():
    import pytest

    with pytest.raises(ValueError):
        PeerNetworkSim(2, capacity=16, topology="bridge")


def test_multihost_init_idempotent_guard():
    from bullet_tpu.parallel import multihost

    # single process: is_initialized is False; we only verify the guard path
    # doesn't raise when called on an uninitialized runtime with bad args
    assert multihost.is_multihost() is False


def test_js_utf16_string_order():
    """JS compares UTF-16 code units: an astral-plane emoji must sort BELOW
    U+FFFD (its lead surrogate D83D < FFFD), unlike Python code-point order."""
    from bullet_tpu.utils.jsvalues import less_than
    from bullet_tpu.utils.encode import ValueInterner

    emoji, repl = "\U0001F600", "�"
    assert emoji > repl  # Python code-point order (the wrong one)
    assert less_than(emoji, repl)  # JS order

    vi = ValueInterner()
    k_emoji = vi.encode(emoji)[:3]
    k_repl = vi.encode(repl)[:3]
    assert k_emoji < k_repl  # device order keys follow JS order


def test_js_to_number_strictness():
    from bullet_tpu.utils.jsvalues import to_number
    import math

    assert math.isnan(to_number("1_000"))  # PEP 515 underscores rejected
    assert math.isnan(to_number("inf"))
    assert math.isnan(to_number("infinity"))
    assert to_number("Infinity") == math.inf
    assert to_number("-Infinity") == -math.inf
    assert to_number("0b101") == 5
    assert to_number("0o17") == 15
    assert to_number("0x1A") == 26
    assert to_number("  42  ") == 42
    assert to_number("") == 0
    assert to_number(".5") == 0.5
    assert to_number("1e3") == 1000


def test_js_number_string():
    from bullet_tpu.utils.jsvalues import js_number_string as j

    assert j(0.000001) == "0.000001"
    assert j(1e-7) == "1e-7"
    assert j(1.5e-7) == "1.5e-7"
    assert j(1e21) == "1e+21"
    assert j(1e20) == "100000000000000000000"
    assert j(123.456) == "123.456"
    assert j(100.0) == "100"
    assert j(-0.5) == "-0.5"
    assert j(0.0) == "0"
    assert j(-1e-8) == "-1e-8"
    assert j(float("nan")) == "NaN"
    assert j(float("inf")) == "Infinity"
    assert j(1234567890123456789012.0) == "1.2345678901234568e+21"


def test_delete_works_on_schema_bound_paths(bullet_factory):
    """Null puts (deletes) must pass validation — replicated deletes were
    silently vetoed on schema-bound paths."""
    b = bullet_factory()
    b.define_schema("user", {"type": "object",
                             "properties": {"name": {"type": "string"}}})
    b.apply_schema("users", "user")
    b.get("users/alice").put({"name": "Alice"})
    b.get("users/alice").remove()
    assert b.store["users"]["alice"] is None


def test_array_clock_marker_stripped_over_network():
    """Array broadcasts carry a trailing clock marker; receivers must strip
    it (the reference stores it — documented divergence)."""
    import time

    p1 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "connect_sync_delay": 0.05})
    p2 = bt.create({"storage": False, "host": "127.0.0.1", "port": 0,
                    "peers": [f"tcp://127.0.0.1:{p1.network.port}"],
                    "connect_sync_delay": 0.05})
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not (p1.network.peers and p2.network.peers):
            time.sleep(0.05)
        p1.get("lists/x").put([1, 2, 3])
        deadline = time.time() + 10
        while time.time() < deadline and not p2.store.get("lists", {}).get("x"):
            time.sleep(0.05)
        assert p2.store["lists"]["x"] == [1, 2, 3]
        # sync path too
        p1.set_data("lists/y", [4, 5], broadcast=False)
        p2.network.request_sync()
        deadline = time.time() + 10
        while time.time() < deadline and not p2.store.get("lists", {}).get("y"):
            time.sleep(0.05)
        assert p2.store["lists"]["y"] == [4, 5]
    finally:
        p1.close()
        p2.close()


def test_rewrite_path_reference_semantics(bullet_factory):
    """Callback gets (match, group1, ...); string replacement uses $1 and
    replaces only the first occurrence (JS String.replace without /g)."""
    b = bullet_factory()
    b.get("real/a/data").put(1)
    b.middleware.rewrite_path(r"alias/(\w+)", lambda match, g1: f"real/{g1}")
    assert b.get("alias/a/data").value() == 1

    b2 = bullet_factory()
    b2.get("v2/x/v1").put(7)  # second occurrence of "v1" must NOT rewrite
    b2.middleware.rewrite_path(r"v1", "v2")
    assert b2.get("v1/x/v1").value() == 7

    b3 = bullet_factory()
    b3.get("new/item").put(3)
    b3.middleware.rewrite_path(r"old/(\w+)", r"new/$1")
    assert b3.get("old/item").value() == 3


def test_restart_pinned_peer_id_first_write_lands(tmp_path):
    opts = {"disable_network": True, "storage": True, "storage_type": "file",
            "storage_path": str(tmp_path / "s"), "save_interval": 0,
            "peer_id": "fixed-peer-id"}
    b = bt.create(opts)
    b.get("k").put("v1")
    b.close()
    b2 = bt.create(opts)
    b2.get("k").put("v2")  # first post-restart write must not be dropped
    assert b2.get("k").value() == "v2"
    b2.close()


def test_autovivify_off_deep_path_through_falsy():
    import bullet_tpu as bt2

    b = bt2.create({"storage": False, "disable_network": True,
                    "autovivify": False})
    b.get("a/b").put(0)
    assert b.get("a/b").value() == 0
    assert b.get("a/b/c").value() is None  # not 0
    b.close()


def test_peer_send_never_blocks_on_stalled_reader():
    """ADVICE r1 (medium): conn.send ran blocking sendall while callers held
    bullet._lock; a peer with a full TCP buffer stalled the writer (mutual
    deadlock between two busy peers). Sends are now queued to a per-connection
    writer thread — enqueueing must return immediately no matter how much the
    remote refuses to read."""
    import socket
    import time as _time

    from bullet_tpu.db.network import _PeerConnection

    a, b = socket.socketpair()
    # shrink buffers so a blocking sendall would wedge within a few messages
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    conn = _PeerConnection(a, "stalled-peer", outbound=True)
    try:
        payload = {"type": "put", "path": "x", "data": "y" * 65536}
        start = _time.monotonic()
        for _ in range(64):  # ~4 MB >> any socket buffer; b never reads
            assert conn.send(payload)
        assert _time.monotonic() - start < 2.0, "send() blocked on peer buffer"
    finally:
        conn.close()
        b.close()


def test_empty_vector_clock_is_not_missing():
    """ADVICE r1: JS `!{}` is false, so an empty {} clock (reachable via sync
    entries with empty vectorClock metadata) must take the comparison path,
    not the missing-clock branch (bullet-crt.js:68-95,171)."""
    from bullet_tpu.db.crt import compare_vector_clocks

    # {} vs {} -> no domination either way -> 0 (concurrent/equal), not -1
    assert compare_vector_clocks({}, {}) == 0
    assert compare_vector_clocks(None, {}) == -1
    assert compare_vector_clocks({}, None) == 1
    assert compare_vector_clocks({}, {"a": 1}) == -1
    assert compare_vector_clocks({"a": 1}, {}) == 1

    # resolve with an EMPTY current clock must not take "no current state"
    b = bt.create({"storage": False, "disable_network": True})
    try:
        d = b.crt.resolve("k", {"a": 1}, {}, "new", "old")
        assert d.reason != "no current state"
        assert d.incoming and d.value == "new"  # incoming clock dominates {}
        # {} vs {}: identical clocks -> value comparison (not "no current state")
        d2 = b.crt.resolve("k2", {}, {}, 5, 3)
        assert d2.reason == "identical clocks, decided by value comparison"
        assert d2.value == 5
    finally:
        b.close()


def test_rewrite_path_dollar_escapes(bullet_factory):
    """ADVICE r1: '$$1' in a JS String.replace replacement is the literal
    '$1', not a group backreference; backslashes pass through literally."""
    b = bullet_factory()
    b.get(r"lit/$1").put("dollar-one")
    b.middleware.rewrite_path(r"esc/(\w+)", r"lit/$$1")
    assert b.get("esc/anything").value() == "dollar-one"

    b2 = bullet_factory()
    b2.get(r"has\slash/x").put(7)
    b2.middleware.rewrite_path(r"alias/(\w+)", r"has\slash/$1")
    assert b2.get("alias/x").value() == 7

    # out-of-range group refs stay literal (JS behavior)
    b3 = bullet_factory()
    b3.get("kept/$9").put("literal-nine")
    b3.middleware.rewrite_path(r"in/(\w+)", r"kept/$9")
    assert b3.get("in/x").value() == "literal-nine"


def test_csv_numeric_coercion_js_semantics():
    """ADVICE r1: CSV import numeric gate is JS isNaN/parseInt/parseFloat —
    '1_000' stays a string, '1e5' is parseInt's 1, 'Infinity' is NaN."""
    import math as _math

    from bullet_tpu.db.serializer import _convert_csv_value

    assert _convert_csv_value("1_000") == "1_000"  # JS ToNumber('1_000') = NaN
    assert _convert_csv_value("1e5") == 1  # parseInt('1e5', 10)
    v = _convert_csv_value("Infinity")
    assert isinstance(v, float) and _math.isnan(v)  # parseInt('Infinity')
    assert _convert_csv_value("1.5e2") == 150.0  # parseFloat (has '.')
    assert _convert_csv_value("42") == 42
    assert _convert_csv_value("-3.25") == -3.25
    assert _convert_csv_value("0x10") == 0  # !isNaN('0x10'); parseInt(,10)=0
    assert _convert_csv_value("abc") == "abc"
    assert _convert_csv_value("") is None
    assert _convert_csv_value("TRUE") is True


def test_zero_round_frontier_does_not_fake_convergence():
    """A run_until_converged(max_rounds=0) call runs zero rounds; it must
    NOT report residual 0 while replicas still differ, and a later
    convergence must still reach the fixed point."""
    import numpy as np

    from bullet_tpu.models.netsim import PeerNetworkSim

    for layout in ("packed", "dense"):
        sim = PeerNetworkSim(8, capacity=1024, topology="ring", layout=layout)
        sim.put(0, "a/x", 1)
        sim.run_until_converged()
        assert sim.tables_equal()
        sim.put(2, "a/y", 7)
        r = sim.run_until_converged(max_rounds=0)  # applies, gossips nothing
        assert r == 0
        assert sim.last_residual != 0  # not converged — and must not claim so
        sim.run_until_converged()
        assert sim.tables_equal(), layout
        assert sim.get(0, "a/y") == 7, layout


def test_bulk_bool_rejected_for_number_fields():
    """Review session-2: booleans encode as CLS_NUMBER, so the device mask
    alone accepted them for "number"-typed fields while scalar put rejects
    (JS typeof true is "boolean"); the strict host mask must drop them —
    scalar and bulk writes agree (docs/validation.md contract)."""
    import numpy as np

    from bullet_tpu.models.netsim import PeerNetworkSim

    sim = PeerNetworkSim(4, capacity=128, topology="ring")
    sim.define_schema("m", {"properties": {"v": {"type": "number"}}})
    sim.apply_schema("items", "m")
    assert not sim.put(0, "items/a/v", True)  # scalar: rejected
    sim.put_bulk(np.asarray([0, 1]), ["items/b/v", "items/c/v"],
                 [True, 2.5])  # mixed list must NOT coerce the bool
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] >= 1
    assert sim.get(2, "items/b/v") is None  # bool dropped
    assert sim.get(2, "items/c/v") == 2.5  # number landed


def test_bulk_after_put_fires_without_put_hook():
    """Review session-2: put_bulk only queued afterPut inside the put-hook
    branch, so afterPut/"write" listeners silently missed bulk rows unless
    an unrelated put hook happened to be registered."""
    import numpy as np

    from bullet_tpu.models.netsim import PeerNetworkSim

    sim = PeerNetworkSim(4, capacity=128, topology="ring")
    seen = []
    sim.use("afterPut", lambda path, value, peer=None: seen.append(path))
    sim.put_bulk(np.asarray([0, 1]), ["a/x", "a/y"], np.array([1.0, 2.0]))
    sim.step()
    assert sorted(seen) == ["a/x", "a/y"]

    # and validation-rejected rows must NOT claim a write happened
    sim2 = PeerNetworkSim(4, capacity=128, topology="ring")
    fired = []
    sim2.use("afterPut", lambda path, value, peer=None: fired.append(path))
    sim2.define_schema("m", {"properties": {"v": {"type": "number",
                                                  "min": 0}}})
    sim2.apply_schema("items", "m")
    sim2.put_bulk(np.asarray([0, 1]), ["items/a/v", "items/b/v"],
                  np.array([5.0, -5.0]))
    sim2.step()
    assert fired == ["items/a/v"]  # the vetoed row stays silent


def test_sharded_frontier_residual_zero_at_fixed_point():
    """An already-converged sharded sim entering the shard_map loop again
    reports last_residual == 0, not the loop's init sentinel."""
    from bullet_tpu.models.netsim import PeerNetworkSim

    sim = PeerNetworkSim(16, capacity=2048, topology="ring",
                         layout="packed", mesh_devices=8, use_shard_map=True)
    sim.put(0, "s/x", 3)
    sim.run_until_converged()
    assert sim.tables_equal()
    sim.run_until_converged()  # nothing pending: already at the fixed point
    assert sim.last_residual == 0


def test_ws_empty_text_frame_is_not_eof():
    """Review session-2: a zero-length text frame (legal per RFC 6455) was
    conflated with EOF and tore down a healthy link."""
    import socket as socket_mod
    import time as time_mod

    import bullet_tpu as bt
    from bullet_tpu.db import ws

    p1 = bt.create({"storage": False, "port": 0, "host": "127.0.0.1"})
    try:
        # raw ws client handshake
        sock = socket_mod.create_connection(("127.0.0.1", p1.network.port))
        reader = sock.makefile("rb")
        ws.client_handshake(sock, reader, "127.0.0.1", p1.network.port,
                            {"x-peer-id": "probe-peer"})
        # empty text frame, then a real put
        sock.sendall(ws.encode_frame(b"", ws.OP_TEXT, mask=True))
        put = ('{"type": "put", "id": "m1", "path": "w/z", '
               '"data": {"v": 7}, "ttl": 2}')
        sock.sendall(ws.encode_frame(put.encode(), ws.OP_TEXT, mask=True))
        for _ in range(100):
            if p1.get("w/z").value() == {"v": 7}:
                break
            time_mod.sleep(0.05)
        assert p1.get("w/z").value() == {"v": 7}  # link survived the ""
        sock.close()
    finally:
        p1.close()


def test_parse_int_is_float64():
    """Review session-2: JS parseInt returns a Number (float64); long digit
    strings round and huge ones overflow to Infinity."""
    import math as math_mod

    from bullet_tpu.utils.jsvalues import js_parse_int

    assert js_parse_int("42") == 42
    assert js_parse_int("9007199254740993") == 9007199254740992
    assert js_parse_int("9" * 400) == math_mod.inf
    assert js_parse_int("-" + "9" * 400) == -math_mod.inf
    assert isinstance(js_parse_int("1" + "0" * 30), float)  # 1e30 > 2^63
