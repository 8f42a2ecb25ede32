"""Engine batch-ingress pipeline: schemas compiled into device masks +
middleware hooks at the batch boundary + traced transforms + changed-slot
subscriptions, all on the engine (models/ingress.py).

The db-layer equivalents live in validation_example.py and
middleware_example.py; this demo shows the same capabilities at engine
scale, where validation runs as jit compare masks over encoded keys and a
put-middleware can be traced INTO the compiled step.
"""

import _env  # noqa: F401  (backend selection)

import numpy as np

from bullet_tpu.models.netsim import PeerNetworkSim


def main() -> None:
    sim = PeerNetworkSim(8, capacity=1024, topology="mesh")

    # -- schema validation at batch ingress -------------------------------
    sim.define_schema(
        "reading",
        {
            "properties": {
                "celsius": {"type": "number", "min": -90, "max": 60},
                "station": {"type": "string"},
                "quality": {"type": "string", "enum": ["good", "suspect"]},
            }
        },
    )
    sim.apply_schema("readings", "reading")
    rejected = []
    sim.on_validation_error("all", lambda e: rejected.append(str(e)))

    # scalar puts: host typed checks
    assert sim.put(0, "readings/r0/celsius", 21.5)
    assert not sim.put(0, "readings/rX/celsius", 120.0)  # above max
    assert not sim.put(0, "readings/rX/quality", "bad-enum")

    # bulk ingestion: the compiled device mask vetoes invalid rows
    k = 1000
    rng = np.random.default_rng(0)
    temps = rng.uniform(-120, 90, size=k)  # ~1/3 outside [-90, 60]
    sim.put_bulk(
        rng.integers(0, 8, size=k).astype(np.int32),
        [f"readings/r{i}/celsius" for i in range(k)],
        temps,
    )
    sim.run_until_converged()
    assert sim.tables_equal()
    expected_bad = int(((temps < -90) | (temps > 60)).sum())
    assert sim.stats["ops_rejected"] == expected_bad
    print(f"device validation vetoed {sim.stats['ops_rejected']}/{k} bulk rows "
          f"({len(rejected)} typed errors)")

    # every surviving reading is in range on every replica
    hits = sim.range(3, "readings", "celsius", -90, 60)
    print(f"range query sees {len(hits)} valid readings")

    # -- middleware hooks at the batch boundary ----------------------------
    audit = []
    sim.use("put", lambda path, data, peer: (
        False if path.startswith("readings/frozen") else None))
    sim.use("afterPut", lambda path, data, peer: audit.append((peer, path)))
    sim.on_event("write", lambda d: None)

    assert not sim.put(2, "readings/frozen/celsius", 1.0)  # vetoed
    assert sim.put(2, "readings/r0/station", "north-ridge")
    sim.step()
    assert audit == [(2, "readings/r0/station")]
    print("hook pipeline: veto + afterPut audit trail working")

    # -- a pure transform traced into the jitted step ----------------------
    import jax.numpy as jnp

    from bullet_tpu.utils.encode import CLS_NUMBER, number_key

    hi, lo = number_key(60.0)
    vid60 = sim.host.encode_value(60.0)[3]

    def clamp_to_max(ops, struct):
        # clamp numeric ops above 60 to exactly 60, at device line rate
        over = (ops.cls == CLS_NUMBER) & (
            (ops.khi > hi) | ((ops.khi == hi) & (ops.klo > lo))
        )
        return ops._replace(
            khi=jnp.where(over, hi, ops.khi),
            klo=jnp.where(over, lo, ops.klo),
            vid=jnp.where(over, vid60, ops.vid),
        )

    sim.use_traced_put(clamp_to_max)
    # bulk rows hit the traced transform BEFORE the device validation mask
    # (scalar puts validate eagerly at put() time, so they go through the
    # host check instead) — the 10,000 clamps to 60 and then passes
    rejected_before = sim.stats["ops_rejected"]
    sim.put_bulk(
        np.array([1, 1], dtype=np.int32),
        ["readings/clamped/celsius", "readings/clamped2/celsius"],
        np.array([59.0, 10_000.0]),
    )
    sim.run_until_converged()
    assert sim.get(5, "readings/clamped/celsius") == 59.0
    assert sim.get(5, "readings/clamped2/celsius") == 60.0
    assert sim.stats["ops_rejected"] == rejected_before  # clamp saved it
    print("traced put transform: out-of-range write clamped inside the step")

    # -- changed-slot subscriptions ----------------------------------------
    fired = []
    sim.on(4, "readings/r0", fired.append)
    sim.step()  # baseline
    # reference mode is comparator value-max (quirk Q2): the new value must
    # win the merge to register as a change
    sim.put(0, "readings/r0/celsius", 38.5)
    sim.run_until_converged()
    assert fired[-1]["celsius"] == 38.5
    print(f"subscription fired {len(fired)}x (immediate + changed-slot)")

    print("Engine pipeline example completed")


if __name__ == "__main__":
    main()
