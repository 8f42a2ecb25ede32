"""Native string-order index: availability, API, and bit-identical ranks vs
the pure-Python implementation."""

import random

import pytest

from bullet_tpu.native import load, make_string_order_index
from bullet_tpu.utils.encode import StringOrderIndex

needs_native = pytest.mark.skipif(load() is None, reason="no native toolchain")


@needs_native
def test_native_lib_loads():
    idx = make_string_order_index()
    assert type(idx).__name__ == "NativeStringOrderIndex"


@needs_native
def test_native_matches_python_exactly():
    """Same insertion sequence ⇒ identical ranks and rebalance points (ranks
    feed the device order keys, so this must be exact)."""
    rng = random.Random(0)
    words = []
    base = "m"
    for i in range(500):
        choice = rng.random()
        if choice < 0.4:
            base = base + rng.choice("az")  # adversarial adjacent inserts
            words.append(base)
        elif choice < 0.7:
            words.append("w" + str(rng.randrange(1000)))
        else:
            words.append(rng.choice(words) if words else "seed")

    py = StringOrderIndex()
    nat = make_string_order_index()
    for w in words:
        r_py, b_py = py.insert(w)
        r_nat, b_nat = nat.insert(w)
        assert (r_py, b_py) == (r_nat, b_nat), w
    assert py.rebalances == nat.rebalances
    for w in set(words):
        assert py.rank(w) == nat.rank(w)
    assert len(nat) == len(set(words))


@needs_native
def test_native_rank_missing_raises():
    nat = make_string_order_index()
    with pytest.raises(KeyError):
        nat.rank("ghost")


@needs_native
def test_native_unicode_ordering():
    nat = make_string_order_index()
    words = ["apple", "Ápple", "zèbra", "日本語", "z", "éclair"]
    for w in words:
        nat.insert(w)
    ranks = {w: nat.insert(w)[0] for w in words}
    for a in words:
        for b in words:
            if a < b:  # Python codepoint order == UTF-8 byte order
                assert ranks[a] < ranks[b], (a, b)


def test_fallback_when_disabled(monkeypatch):
    import bullet_tpu.native as native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    idx = native.make_string_order_index()
    assert isinstance(idx, StringOrderIndex)


def test_interner_uses_factory():
    from bullet_tpu.utils.encode import ValueInterner

    interner = ValueInterner()
    interner.encode("hello")
    interner.encode("world")
    k1 = interner.encode("hello")[:3]
    k2 = interner.encode("world")[:3]
    assert k1 < k2


# ------------------------------------------------------ native path interner


def _fuzz_paths(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [f"s{rng.integers(12)}" for _ in range(rng.integers(1, 5))]
        p = "/".join(parts)
        r = rng.random()
        if r < 0.1:
            p = "/" + p
        elif r < 0.2:
            p = p + "//"
        elif r < 0.25:
            p = p.replace("/", "//", 1)
        out.append(p)
    return out


def test_native_path_interner_matches_python():
    """Ids, segment ids, tree structure, and strings must be bit-identical
    between the native interner and the Python PathInterner for interleaved
    scalar/bulk interning (ranks feed device slot ids)."""
    import numpy as np

    from bullet_tpu.native import NativePathInterner, load
    from bullet_tpu.utils.paths import PathInterner

    lib = load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    npi, ppi = NativePathInterner(lib), PathInterner()
    paths = _fuzz_paths(42, 8000)
    for p in paths[:3000]:
        assert npi.intern(p) == ppi.intern(p), p
    got = npi.intern_batch(paths[3000:])
    want = np.asarray([ppi.intern(p) for p in paths[3000:]], dtype=np.int32)
    np.testing.assert_array_equal(got, want)
    assert len(npi) == len(ppi)
    for pid in range(len(ppi)):
        assert npi.path(pid) == ppi.path(pid)
        assert npi.parent(pid) == ppi.parent(pid)
        assert npi.segment(pid) == ppi.segment(pid)
        assert npi.children(pid) == ppi.children(pid)
        assert list(npi.descendants(pid)) == list(ppi.descendants(pid))
    assert npi.top_level() == ppi.top_level()
    assert sorted(dict(npi.items())) == sorted(dict(ppi.items()))
    for probe in ("s1/s2", "s0", "nope", "", "s1//s3/"):
        assert npi.lookup(probe) == ppi.lookup(probe), probe
    assert ("s1/s2" in npi) == ("s1/s2" in ppi)


def test_native_path_interner_nul_fallback():
    """A path embedding NUL breaks the joined-buffer fast prep; the fallback
    must produce identical results."""
    import numpy as np

    from bullet_tpu.native import NativePathInterner, load
    from bullet_tpu.utils.paths import PathInterner

    lib = load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    weird = ["a\x00b/c", "a/b", "a\x00b", "plain"]
    npi, ppi = NativePathInterner(lib), PathInterner()
    np.testing.assert_array_equal(
        npi.intern_batch(weird),
        np.asarray([ppi.intern(w) for w in weird], dtype=np.int32),
    )
    assert npi.path(npi.lookup("a\x00b/c")) == "a\x00b/c"


def test_native_graphhost_struct_matches_python():
    """GraphHost struct export (parent/parent2/seg) must be identical with
    either interner backend — the arrays drive every device query scan."""
    import numpy as np

    from bullet_tpu.models.table import GraphHost
    from bullet_tpu.native import load
    from bullet_tpu.utils.paths import PathInterner

    if load() is None:
        pytest.skip("native toolchain unavailable")

    def build(force_py):
        host = GraphHost(capacity=32)
        if force_py:
            host.paths = PathInterner()
            host._native_paths = False
        for p in _fuzz_paths(7, 500):
            host.intern_path(p)
        host.intern_batch(_fuzz_paths(8, 500))
        host._seg_id("manual_field")
        s = host.struct()
        return (
            np.asarray(s.parent), np.asarray(s.parent2), np.asarray(s.seg),
            host.seg_lookup("manual_field"), host.capacity,
        )

    native = build(False)
    python = build(True)
    for a, b in zip(native, python):
        np.testing.assert_array_equal(a, b)


def test_native_path_interner_bulk_speed():
    """The whole point: 1M novel paths in one call, well under a second."""
    import time

    from bullet_tpu.native import NativePathInterner, load

    lib = load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    paths = [f"g/k{i}" for i in range(1_000_000)]
    npi = NativePathInterner(lib)
    t0 = time.perf_counter()
    slots = npi.intern_batch(paths)
    dt = time.perf_counter() - t0
    assert len(npi) == 1_000_001
    assert slots[0] != slots[1]
    assert dt < 2.0, f"bulk intern took {dt:.2f}s"  # typ. ~0.35s; CI slack


def test_native_path_interner_deep_paths():
    """Code-review r2: build_path must not truncate — a 600-segment path
    round-trips exactly (the old fixed 512-entry chain dropped root-most
    segments and disagreed with pin_paths_blob_len)."""
    from bullet_tpu.native import NativePathInterner, load
    from bullet_tpu.utils.paths import PathInterner

    lib = load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    deep = "/".join(f"d{i}" for i in range(600))
    npi, ppi = NativePathInterner(lib), PathInterner()
    pid_n, pid_p = npi.intern(deep), ppi.intern(deep)
    assert pid_n == pid_p
    assert npi.path(pid_n) == deep == ppi.path(pid_p)


def test_native_group_positions_bitidentical():
    """bk_group_positions must match the numpy argsort-based twin
    (models/netsim.py::_group_positions fallback) exactly."""
    import numpy as np

    from bullet_tpu import native

    if native.load() is None:
        import pytest

        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(11)
    for k, p in ((0, 4), (1, 1), (17, 3), (100_000, 64)):
        peers = rng.integers(0, p, k).astype(np.int32)
        seq, counts = native.group_positions(peers, p)
        c2 = np.bincount(peers, minlength=p)
        order = np.argsort(peers, kind="stable")
        sp = peers[order]
        boundaries = np.flatnonzero(np.diff(sp)) + 1
        starts = np.concatenate(([0], boundaries))
        gs = np.diff(np.concatenate((starts, [k])))
        seq_sorted = np.arange(k) - np.repeat(starts, gs)
        s2 = np.empty(k, dtype=np.int64)
        s2[order] = seq_sorted
        np.testing.assert_array_equal(seq, s2, err_msg=str((k, p)))
        np.testing.assert_array_equal(counts, c2, err_msg=str((k, p)))


def test_native_number_keys_bitidentical():
    """bk_number_keys must match number_keys_np (keys) and the numpy
    canonical-intern-bits construction exactly, including ±0.0, NaN
    payloads, infinities, and denormals."""
    import numpy as np

    from bullet_tpu import native
    from bullet_tpu.utils.encode import _RAW_NAN_BITS, number_keys_np

    if native.load() is None:
        import pytest

        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(13)
    edge = np.array([
        0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5,
        5e-324, -5e-324, 1e308, -1e308, 123456.789, -0.001,
    ])
    # a NaN with a nonstandard payload must canonicalize identically
    weird_nan = np.frombuffer(
        np.uint64(0x7FF0000000000001).tobytes(), dtype=np.float64
    )
    vals = np.concatenate([edge, weird_nan, rng.standard_normal(50_000) * 1e6])
    khi, klo, raw = native.number_keys(vals)
    k2, l2 = number_keys_np(vals)
    np.testing.assert_array_equal(khi, k2)
    np.testing.assert_array_equal(klo, l2)
    f = vals.copy()
    f[f == 0.0] = 0.0
    b = f.view(np.uint64).copy()
    b[np.isnan(f)] = np.uint64(_RAW_NAN_BITS)
    np.testing.assert_array_equal(raw, b)


def test_native_reduce_flat_ops_bitidentical():
    """bk_reduce_flat_ops must match the numpy argsort+reduceat reduction
    (ops/packed.py::reduce_flat_ops fallback) exactly, including
    duplicate-heavy groups, lexmax ties, cls=0 filtering, and
    empty/all-filtered batches."""
    import numpy as np
    import pytest

    from bullet_tpu import native
    from bullet_tpu.ops.packed import reduce_flat_ops

    if native.load() is None:
        pytest.skip("native toolchain unavailable")

    def numpy_ref(*args, **kw):
        native._load_failed = True
        try:
            return reduce_flat_ops(*args, **kw)
        finally:
            native._load_failed = False

    rng = np.random.default_rng(29)
    for trial in range(20):
        k = int(rng.integers(1, 20000))
        p = int(rng.choice([8, 64, 1024]))
        n = int(rng.choice([1 << 14, 1 << 17, 1 << 20]))
        peer = rng.integers(0, p, k).astype(np.int32)
        slot = rng.integers(0, n, k).astype(np.int32)
        if trial % 2:  # duplicate-heavy: deep groups, many ties
            slot = (slot % 97).astype(np.int32)
            peer = (peer % 3).astype(np.int32)
        cls = rng.integers(0, 5, k).astype(np.int32)
        khi = rng.integers(-(2**31), 2**31, k).astype(np.int32)
        klo = rng.integers(-(2**31), 2**31, k).astype(np.int32)
        vid = rng.integers(0, 1 << 28, k).astype(np.int32)
        a = reduce_flat_ops(peer, slot, cls, khi, klo, vid)
        b = numpy_ref(peer, slot, cls, khi, klo, vid)
        if a is None or b is None:
            assert a is None and b is None, trial
            continue
        for x, y, nm in zip(a, b, "peer slot khi klo cv".split()):
            np.testing.assert_array_equal(x, y, err_msg=f"{trial} {nm}")
    z = np.zeros(10, np.int32)
    assert reduce_flat_ops(z, z, z, z, z, z) is None
    e = np.empty(0, np.int32)
    assert reduce_flat_ops(e, e, e, e, e, e) is None


def test_native_lookup_batch_bitidentical():
    """pin_lookup_batch must match the Python PathInterner.lookup_batch
    (-1 sentinel, normalization, empty/unknown/NUL-free edge paths) and
    never intern."""
    import numpy as np
    import pytest

    from bullet_tpu import native
    from bullet_tpu.utils.paths import PathInterner

    lib = native.load()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    npi = native.NativePathInterner(lib)
    ppi = PathInterner()
    rng = np.random.default_rng(31)
    paths = [
        f"a{int(i)}/b{int(j)}/c"
        for i, j in zip(rng.integers(0, 50, 2000), rng.integers(0, 40, 2000))
    ]
    for p in paths[:1500]:
        assert npi.intern(p) == ppi.intern(p)
    probe = paths + ["unknown/x", "", "a0", "a0/b0", "//a0///b0/"]
    before = len(npi)
    np.testing.assert_array_equal(
        npi.lookup_batch(probe), ppi.lookup_batch(probe)
    )
    assert len(npi) == before  # lookup never interns


def test_stale_abi_library_is_rebuilt(tmp_path, monkeypatch):
    """A stale .so that still EXPORTS every symbol but reports an older
    ABI version must be rejected and rebuilt — a name-only probe once let
    a 16-arg bk_rank_insert_batch receive the 17-arg call, silently
    writing new_ranks into the wrong output buffer."""
    import subprocess
    import sys

    from bullet_tpu import native as nat

    # a decoy library: every probe-relevant symbol exists, ABI version 1
    src = tmp_path / "old.cpp"
    src.write_text(
        'extern "C" int bk_abi_version() { return 1; }\n'
        'extern "C" int bk_rank_insert_batch() { return -1; }\n'
    )
    lib = tmp_path / "libbulletnative.so"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", str(src), "-o", str(lib)],
        check=True,
    )
    # fresh interpreter: point the loader at the decoy (real sources, so
    # the rebuild overwrites the decoy with a current library)
    code = f"""
import shutil
import bullet_tpu.native as n
n._LIB = {str(lib)!r}
lib = n.load()
assert lib is not None, "loader gave up instead of rebuilding"
assert int(lib.bk_abi_version()) == n._ABI_VERSION
print("REBUILT_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=240,
    )
    assert "REBUILT_OK" in out.stdout, (out.stdout, out.stderr)
