"""Benchmark: merged graph ops/sec/chip (the BASELINE.json primary metric).

Runs the engine's XLA ring gossip loop on the rank1 layout (4 B/entry) at
the north-star shape, 1,024 peers × 2^20 slots, on one GPU. The measured
unit is one CRT merge decision — one (entry vs entry) winner-select, i.e.
what one bullet-crt ``resolve`` call does per path
(/root/reference/src/bullet-crt.js:164-279): a ring round makes two per
entry. The reference publishes no numbers (BASELINE.md: ``published:
{}``), so ``vs_baseline`` is measured against the north-star target of
100M merged ops/sec.

The rounds run as one compiled ``fori_loop`` on a donated table; the timed
call ends in ``block_until_ready`` and compilation happens before it.
Fewer rounds than the ring's diameter run, so every round advances real
protocol state. Needs a GPU: it exits nonzero when JAX finds none.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import functools
import json
import sys
import time

NUM_PEERS, CAPACITY, ROUNDS = 1024, 1 << 20, 64
NORTH_STAR = 100e6  # BASELINE.json north_star: >100M merged ops/sec


def make_rank1_table(num_peers: int, capacity: int):
    """Deterministic pseudo-random rank1 table built on device in one
    fused program: rank 0 = absent, live ranks spread over 30 bits like a
    RankIndex would assign them."""
    import jax
    import jax.numpy as jnp

    from bullet_tpu.ops.rank import Rank1Table

    @jax.jit
    def build():
        row = jax.lax.broadcasted_iota(jnp.int32, (num_peers, capacity), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (num_peers, capacity), 1)
        h = (row * 1103515245 + col * 40503) & 0x7FFFFFFF

        def mix(salt, mod):
            return ((h ^ salt) * 1664525 & 0x7FFFFFFF) % mod

        return Rank1Table(rank=jnp.where(mix(1, 4) > 0, mix(8, 1 << 30) + 1, 0))

    return build()


def bench_ring(num_peers: int, capacity: int, rounds: int) -> float:
    """Merge decisions per second of ``rounds`` fused XLA ring rounds."""
    import jax

    from bullet_tpu.ops.packed import gossip_round_ring_packed

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(table):
        return jax.lax.fori_loop(
            0, rounds, lambda _, t: gossip_round_ring_packed(t)[0], table
        )

    table = make_rank1_table(num_peers, capacity)
    run.lower(table).compile()  # set-up, outside the timed call
    jax.block_until_ready(run(table))  # warm
    table = make_rank1_table(num_peers, capacity)
    jax.block_until_ready(table)
    t0 = time.perf_counter()
    jax.block_until_ready(run(table))
    dt = time.perf_counter() - t0
    return 2 * num_peers * capacity * rounds / dt


def main() -> None:
    import jax

    from bullet_tpu.utils.compile_cache import enable_compile_cache

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev0.platform}")
    enable_compile_cache()
    rate = bench_ring(NUM_PEERS, CAPACITY, ROUNDS)
    print(
        json.dumps(
            {
                "metric": "merged graph ops/sec/chip (rank1 ring gossip, "
                f"XLA, P={NUM_PEERS}, N={CAPACITY}, {dev0.device_kind})",
                "value": round(rate),
                "unit": "merges/s",
                "vs_baseline": round(rate / NORTH_STAR, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
