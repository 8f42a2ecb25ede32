"""Engine-side validation + middleware at the batch boundary.

Twin of tests/test_validation.py / tests/test_middleware.py core cases for
the engine: scalar puts get host typed checks, bulk batches are vetoed by
compiled device masks before apply_ops, and the hook pipeline wraps the
engine write/read paths.
"""

import math

import numpy as np
import pytest

from bullet_tpu.db.validation import ValidationError
from bullet_tpu.models.netsim import PeerNetworkSim


USER_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "required": True},
        "age": {"type": "number", "min": 0, "max": 150},
        "role": {"type": "string", "enum": ["admin", "user", "guest"]},
        "active": {"type": "boolean"},
        "email": {"type": "string", "format": "email"},
    },
    "required": ["name"],
}


@pytest.fixture
def sim():
    s = PeerNetworkSim(4, capacity=256, topology="ring", mode="reference")
    s.define_schema("user", USER_SCHEMA)
    s.apply_schema("users", "user")
    return s


# ------------------------------------------------------------- scalar put


def test_valid_put_passes(sim):
    assert sim.put(0, "users/u1", {"name": "alice", "age": 30, "role": "admin"})
    sim.run_until_converged()
    assert sim.get(2, "users/u1/name") == "alice"


def test_missing_required_blocked(sim):
    errors = []
    sim.on_validation_error("all", errors.append)
    assert not sim.put(0, "users/u2", {"age": 30})
    sim.run_until_converged()
    assert sim.get(0, "users/u2") is None
    assert errors and errors[0].type == "required"


def test_wrong_type_blocked_scalar(sim):
    errors = []
    sim.on_validation_error("type", errors.append)
    assert not sim.put(0, "users/u1/age", "not-a-number")
    assert errors and errors[0].type == "type"


def test_enum_blocked_scalar(sim):
    assert not sim.put(0, "users/u1/role", "superuser")
    assert sim.put(0, "users/u1/role", "guest")


def test_range_blocked_scalar(sim):
    assert not sim.put(0, "users/u1/age", 200)
    assert not sim.put(0, "users/u1/age", -1)
    assert sim.put(0, "users/u1/age", 42)


def test_email_format_scalar(sim):
    assert not sim.put(0, "users/u1/email", "nope")
    assert sim.put(0, "users/u1/email", "a@b.co")


def test_null_put_passes_on_schema_path(sim):
    """Deletes are null puts and must work on schema-bound paths."""
    sim.put(0, "users/u1", {"name": "alice", "age": 5})
    sim.run_until_converged()
    assert sim.put(0, "users/u1/age", None)


def test_explicit_validate_raises(sim):
    with pytest.raises(ValidationError):
        sim.validate("user", {"age": 1})
    assert sim.validate("user", {"name": "x"})


def test_unbound_paths_unaffected(sim):
    assert sim.put(0, "other/x", "anything at all")
    sim.run_until_converged()
    assert sim.get(1, "other/x") == "anything at all"


# ---------------------------------------------------------- device (bulk)


def test_bulk_range_vetoed_on_device(sim):
    """Invalid bulk rows are zeroed by the jit mask before apply_ops."""
    errors = []
    sim.on_validation_error("all", errors.append)
    peers = np.array([0, 1, 2, 3], dtype=np.int32)
    paths = [f"users/u{i}/age" for i in range(4)]
    values = np.array([30.0, 200.0, -5.0, 64.0])  # 200 and -5 violate max/min
    sim.put_bulk(peers, paths, values)
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(0, "users/u0/age") == 30
    assert sim.get(0, "users/u1/age") is None
    assert sim.get(0, "users/u2/age") is None
    assert sim.get(0, "users/u3/age") == 64
    assert len(errors) == 2 and all(e.is_validation_error for e in errors)


def test_bulk_type_vetoed_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/age", "users/u8/age"],
        [12, "twelve"],  # string into a number field
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(1, "users/u7/age") == 12
    assert sim.get(1, "users/u8/age") is None


def test_bulk_enum_vetoed_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/role", "users/u8/role"],
        ["admin", "superuser"],
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(2, "users/u7/role") == "admin"
    assert sim.get(2, "users/u8/role") is None


def test_bulk_boolean_type_on_device(sim):
    sim.put_bulk(
        np.array([0, 0], dtype=np.int32),
        ["users/u7/active", "users/u8/active"],
        # object dtype: a plain [True, 3.5] list would be numpy-coerced to
        # [1.0, 3.5] before the engine ever saw the bool
        np.array([True, 3.5], dtype=object),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 1
    assert sim.get(0, "users/u7/active") is True
    assert sim.get(0, "users/u8/active") is None


def test_bulk_unbound_paths_pass(sim):
    sim.put_bulk(
        np.array([0, 1], dtype=np.int32),
        ["metrics/m0", "metrics/m1"],
        np.array([1.5, -2.5]),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 0
    assert sim.get(3, "metrics/m1") == -2.5


def test_bulk_convergence_after_veto(sim):
    """Vetoed ops must not poison convergence: replicas stay bit-identical."""
    rng = np.random.default_rng(7)
    k = 64
    peers = rng.integers(0, 4, size=k).astype(np.int32)
    paths = [f"users/u{i % 8}/age" for i in range(k)]
    values = rng.uniform(-50, 250, size=k)  # ~half out of [0, 150]
    sim.put_bulk(peers, paths, values)
    sim.run_until_converged()
    assert sim.tables_equal()
    ages = [sim.get(0, f"users/u{i}/age") for i in range(8)]
    assert all(a is None or 0 <= a <= 150 for a in ages)


def test_remove_schema_lifts_rules(sim):
    sim.remove_schema("users")
    sim.put_bulk(np.array([0], dtype=np.int32), ["users/u1/age"], np.array([999.0]))
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 0
    assert sim.get(0, "users/u1/age") == 999


# ---------------------------------------------------------------- hooks


def make_sim():
    return PeerNetworkSim(2, capacity=128, topology="ring")


def test_before_put_veto():
    s = make_sim()
    s.use("put", lambda path, data: False if path.startswith("secret") else None)
    assert not s.put(0, "secret/x", 1)
    assert s.put(0, "open/x", 1)
    s.run_until_converged()
    assert s.get(0, "secret/x") is None
    assert s.get(0, "open/x") == 1


def test_before_put_mutate_data():
    s = make_sim()
    s.use("put", lambda path, data: data * 2 if isinstance(data, (int, float)) else None)
    s.put(0, "n", 21)
    s.run_until_converged()
    assert s.get(1, "n") == 42


def test_before_put_redirect_path():
    s = make_sim()
    s.use("put", lambda path, data: {"path": "real/" + path, "data": data})
    s.put(0, "x", 5)
    s.run_until_converged()
    assert s.get(0, "real/x") == 5
    assert s.get(0, "x") is None


def test_put_hook_error_blocks_write():
    s = make_sim()
    errors = []
    s.on_event("error", errors.append)

    def bad_hook(path, data):
        raise RuntimeError("boom")

    s.use("put", bad_hook)
    assert not s.put(0, "x", 1)
    assert errors and errors[0]["operation"] == "put"


def test_after_put_fires_after_step():
    s = make_sim()
    seen = []
    s.use("afterPut", lambda path, data, peer: seen.append((peer, path, data)))
    s.put(1, "a/b", 9)
    assert seen == []  # not yet applied
    s.step()
    assert seen == [(1, "a/b", 9)]


def test_get_hook_rewrites_path():
    s = make_sim()
    s.put(0, "v2/conf", "new")
    s.run_until_converged()
    s.use("get", lambda path, data: path.replace("v1/", "v2/"))
    assert s.get(0, "v1/conf") == "new"


def test_after_get_transforms_data():
    s = make_sim()
    s.put(0, "greet", "hello")
    s.run_until_converged()
    s.use("afterGet", lambda path, data: data.upper() if isinstance(data, str) else data)
    assert s.get(0, "greet") == "HELLO"


def test_get_hook_error_does_not_block_read():
    s = make_sim()
    s.put(0, "k", 7)
    s.run_until_converged()

    def bad(path, data):
        raise RuntimeError("boom")

    s.use("get", bad)
    assert s.get(0, "k") == 7


def test_events_write_read_all():
    s = make_sim()
    events = []
    s.on_event("write", lambda d: events.append(("write", d["path"])))
    s.on_event("read", lambda d: events.append(("read", d["path"])))
    s.on_event("all", lambda name, d: events.append(("all", name)))
    s.put(0, "e/x", 1)
    s.step()
    s.get(0, "e/x")
    names = [e[0] for e in events]
    assert "write" in names and "read" in names and "all" in names


def test_delete_hooks():
    s = make_sim()
    s.put(0, "doomed", 1)
    s.put(0, "kept", 1)
    s.run_until_converged()
    deleted = []
    s.use("delete", lambda path, data: False if path == "kept" else None)
    s.use("afterDelete", lambda path, data: deleted.append(path))
    assert not s.remove(0, "kept")
    assert s.remove(0, "doomed")
    assert deleted == ["doomed"]


def test_peer_aware_hook_signature():
    s = make_sim()
    seen = []
    s.use("put", lambda path, data, peer: seen.append(peer))
    s.put(1, "x", 1)
    assert seen == [1]


def test_use_unknown_operation_raises():
    s = make_sim()
    with pytest.raises(ValueError):
        s.use("nope", lambda p, d: None)


# ---------------------------------------------------------- traced put


def test_traced_put_transform_runs_in_step():
    """A pure OpBatch transform traces into the jitted step: clamp every
    numeric op's encoded key to <= 100 by swapping in the encoded key of 100."""
    import jax.numpy as jnp

    from bullet_tpu.utils.encode import CLS_NUMBER, number_key

    s = make_sim()
    cap_hi, cap_lo = number_key(100.0)
    cap_vid = s.host.encode_value(100.0)[3]

    def clamp(ops, struct):
        too_big = (ops.cls == CLS_NUMBER) & (
            (ops.khi > cap_hi) | ((ops.khi == cap_hi) & (ops.klo > cap_lo))
        )
        return ops._replace(
            khi=jnp.where(too_big, cap_hi, ops.khi),
            klo=jnp.where(too_big, cap_lo, ops.klo),
            vid=jnp.where(too_big, cap_vid, ops.vid),
        )

    s.use_traced_put(clamp)
    s.put(0, "m/a", 50)
    s.put(0, "m/b", 12345)
    s.run_until_converged()
    assert s.get(1, "m/a") == 50
    assert s.get(1, "m/b") == 100


def test_validation_on_sharded_mesh():
    """Device veto composes with the sharded peer axis (virtual 8-CPU mesh)."""
    s = PeerNetworkSim(8, capacity=128, topology="ring", mesh_devices=8)
    s.define_schema("user", USER_SCHEMA)
    s.apply_schema("users", "user")
    peers = np.arange(8, dtype=np.int32)
    paths = [f"users/u{i}/age" for i in range(8)]
    values = np.where(np.arange(8) % 2 == 0, 30.0, 999.0)
    s.put_bulk(peers, paths, values)
    s.run_until_converged()
    assert s.stats["ops_rejected"] == 4
    assert s.tables_equal()
    assert s.get(0, "users/u0/age") == 30
    assert s.get(0, "users/u1/age") is None


def test_bulk_integer_integralness_enforced(sim):
    """Code-review r2: 'integer' fields must reject fractional bulk values
    (the encoded-key device mask can't see integralness; a host pre-mask
    at put_bulk ingress enforces it)."""
    errors = []
    sim.on_validation_error("all", errors.append)
    sim.define_schema("counted", {"properties": {"n": {"type": "integer"}}})
    sim.apply_schema("counts", "counted")
    sim.put_bulk(
        np.array([0, 1, 2], dtype=np.int32),
        ["counts/a/n", "counts/b/n", "counts/c/n"],
        np.array([3.0, 2.5, float("nan")]),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(3, "counts/a/n") == 3.0
    assert sim.get(3, "counts/b/n") is None
    assert sim.get(3, "counts/c/n") is None
    assert len(errors) == 2


def test_bulk_string_length_enforced(sim):
    sim.define_schema(
        "tagged", {"properties": {"tag": {"type": "string", "min": 3, "max": 5}}}
    )
    sim.apply_schema("tags", "tagged")
    sim.put_bulk(
        np.array([0, 0, 0], dtype=np.int32),
        ["tags/a/tag", "tags/b/tag", "tags/c/tag"],
        np.array(["ok!", "x", "waytoolong"], dtype=object),
    )
    sim.run_until_converged()
    assert sim.stats["ops_rejected"] == 2
    assert sim.get(1, "tags/a/tag") == "ok!"
    assert sim.get(1, "tags/b/tag") is None
    assert sim.get(1, "tags/c/tag") is None


def test_bulk_scalar_parity_for_integer(sim):
    """Scalar and bulk writes must agree on the same schema (the review's
    divergence scenario)."""
    sim.define_schema("counted", {"properties": {"n": {"type": "integer"}}})
    sim.apply_schema("counts", "counted")
    assert not sim.put(0, "counts/z/n", 1.5)  # scalar: host check rejects
    sim.put_bulk(np.array([0], dtype=np.int32), ["counts/z/n"],
                 np.array([1.5]))  # bulk: ingress mask rejects
    sim.run_until_converged()
    assert sim.get(0, "counts/z/n") is None
