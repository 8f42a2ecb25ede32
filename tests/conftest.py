"""Test configuration.

Engine tests run on JAX's CPU backend over a virtual 8-device mesh, so the
multi-device (shard_map) paths run here too. XLA_FLAGS must be set before
the backend initializes, and the platform is pinned through
jax.config.update in ``pytest_configure``.

Tests that need an NVIDIA card carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them where JAX finds no GPU. ``pytest -m gpu``
selects exactly those tests and leaves the platform to JAX, so on a machine
with a card they run on it.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# SIGSEGV mitigation: XLA:CPU splits each program into up to 32 LLVM
# modules compiled in parallel, and every split's ORC object
# __register_frame()s its eh_frame into libgcc. libgcc 12.2.0's lock-free
# eh_frame btree has known insert/lookup races (fixed upstream in GCC
# 12.3); a full-suite run once died inside libgcc's FDE classification
# after ~690 tests of accumulated registrations. One module per program ⇒
# one registration per load ⇒ no concurrent btree writers.
if "xla_cpu_parallel_codegen_split_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ["XLA_FLAGS"]
        + " --xla_cpu_parallel_codegen_split_count=1"
    ).strip()

import threading  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402


def pytest_configure(config):
    import jax

    if config.option.markexpr != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {platform}); "
                    "run `pytest -m gpu` on a machine with one")

# Network threads are named bullet-{accept,read,write,handshake,dial,status}.
# BulletNetwork.close() joins all of them; a test that leaves any alive is a
# teardown bug (the round-4 suite accumulated 100 leaked threads by test #674,
# masking a segfault's stack). Fail loudly instead.
_LEAK_PREFIX = "bullet-"


def _live_bullet_threads():
    return [
        t for t in threading.enumerate()
        if t.name.startswith(_LEAK_PREFIX) and t.is_alive()
    ]


@pytest.fixture(autouse=True)
def _no_leaked_network_threads(request):
    before = set(id(t) for t in _live_bullet_threads())
    yield
    deadline = time.time() + 5.0  # grace for in-flight teardown
    leaked = [t for t in _live_bullet_threads() if id(t) not in before]
    while leaked and time.time() < deadline:
        time.sleep(0.05)
        leaked = [t for t in _live_bullet_threads() if id(t) not in before]
    if leaked:
        names = sorted(t.name for t in leaked)
        pytest.fail(
            f"{request.node.nodeid} leaked {len(leaked)} network thread(s): "
            f"{names} — some BulletNetwork/StatusServer was not close()d",
            pytrace=False,
        )


@pytest.fixture
def bullet_factory():
    """Factory for storage-less, network-less Bullet instances with cleanup."""
    import bullet_tpu as bt

    created = []

    def make(**options):
        opts = {"storage": False, "disable_network": True}
        opts.update(options)
        b = bt.create(opts)
        created.append(b)
        return b

    yield make
    for b in created:
        b.close()
