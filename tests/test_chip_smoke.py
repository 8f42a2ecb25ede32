"""chip_smoke.py's phase functions at tiny sizes: every phase holds the
engine to the per-key-max reference. The ``gpu``-marked cases run the same
phases on the card at a mid size (``pytest -m gpu``)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402

TINY = dict(peers=16, slots=256, keys=64, writes=2000)
ON_CARD = dict(peers=256, slots=1 << 16, keys=1 << 12, writes=1 << 16)


def _setup(layout, peers, slots, keys, writes, seed=3):
    sim = cs.make_sim(layout, peers, slots)
    key_slots = sim.host.intern_batch([f"g/k{i}" for i in range(keys)])
    return sim, key_slots, np.random.default_rng(seed), cs.PerKeyMax(keys)


def _run_phase(phase, layout, size):
    sim, key_slots, rng, ref = _setup(layout, **size)
    label = dict(layout=layout)
    if phase != "converge":  # later phases start from a converged load
        cs.phase_converge(sim, key_slots, rng, ref, size["writes"], label)
    fn = {"converge": cs.phase_converge, "reconcile": cs.phase_reconcile,
          "fast_forward": cs.phase_fast_forward}[phase]
    record = fn(sim, key_slots, rng, ref, size["writes"], label)
    assert record["phase"] == phase and record["wall_s"] >= 0
    assert set(record["memory_analysis"]) >= {"temp_size_in_bytes"}


@pytest.mark.parametrize("phase", ["converge", "reconcile", "fast_forward"])
@pytest.mark.parametrize("layout", ["packed", "rank1"])
def test_phase_matches_per_key_max(layout, phase):
    _run_phase(phase, layout, TINY)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["converge", "reconcile", "fast_forward"])
@pytest.mark.parametrize("layout", ["packed", "rank1"])
def test_phase_on_card(gpu, layout, phase):
    _run_phase(phase, layout, ON_CARD)


@pytest.mark.parametrize("layout", ["packed", "rank1"])
def test_reads_match_per_key_max(layout):
    sim, key_slots, rng, ref = _setup(layout, **TINY)
    cs.phase_converge(sim, key_slots, rng, ref, TINY["writes"], {})
    rec = cs.phase_reads(sim, key_slots, rng, ref, 500, {})
    assert rec["range_hits"] > 0


def test_check_state_catches_a_wrong_replica():
    """The reference comparison must fail on a state the writes cannot
    produce."""
    sim, key_slots, rng, ref = _setup("packed", **TINY)
    cs.phase_converge(sim, key_slots, rng, ref, TINY["writes"], {})
    ref.max[0] += 1.0
    with pytest.raises(cs.SmokeFailure):
        cs.check_state(sim, key_slots, ref, "mutated reference")


def test_sharded_phases_match_per_key_max():
    cs.run_sharded(4, peers=32, slots=256, keys=64, writes=2000, seed=5)


def test_served_path_answers_from_the_mirror():
    rec = cs.run_served(200)
    assert rec["wire_writes_per_s"] > 0


def test_main_refuses_a_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
