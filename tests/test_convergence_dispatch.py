"""Cell-coverage for the convergence strategy table (netsim.py).

``run_until_converged`` dispatches through the declarative
``CONVERGENCE_STRATEGIES`` table. This test enumerates EVERY dispatch cell
and pins which loop implementation each one selects, so a new loop shows
up as exactly one edited row here.
"""

import pytest

from bullet_tpu.models.netsim import (
    CONVERGENCE_STRATEGIES,
    ConvergenceCell,
    PeerNetworkSim,
)


def _pick(cell):
    for name, pred, method in CONVERGENCE_STRATEGIES:
        if pred(cell):
            return name, method
    raise AssertionError("no row matched")


def test_every_cell_resolves_to_documented_row():
    """Exhaustive truth table over the cell space. The expectations ARE the
    dispatch contract — update them deliberately when adding a loop."""
    for layout in ("packed", "rank", "rank1", "dense"):
        name, method = _pick(ConvergenceCell(layout=layout))
        if layout == "dense":
            assert (name, method) == ("dense-loop", "_converge_dense_loop")
        else:
            assert (name, method) == ("packed-loop", "_converge_packed_loop")


def test_first_match_is_unambiguous_for_packed_cells():
    """packed-family cells must never fall through to the dense row."""
    for layout in ("packed", "rank", "rank1"):
        name, _ = _pick(ConvergenceCell(layout))
        assert name.startswith("packed-")


@pytest.mark.parametrize(
    "layout,topology,want",
    [
        ("packed", "ring", "packed-loop"),
        ("packed", "mesh", "packed-loop"),
        ("rank", "ring", "packed-loop"),
        ("rank", "mesh", "packed-loop"),
        ("rank1", "ring", "packed-loop"),
        ("rank1", "mesh", "packed-loop"),
        ("dense", "chain", "dense-loop"),
        ("dense", "star", "dense-loop"),
    ],
)
def test_live_sims_pick_expected_rows(layout, topology, want):
    """End-to-end: a real sim's _convergence_strategy returns the expected
    row."""
    sim = PeerNetworkSim(8, capacity=256, topology=topology, layout=layout)
    name, _runner = sim._convergence_strategy()
    assert name == want
    # and the selected row actually converges the sim (through the public
    # path, which applies pending ops before dispatching)
    sim.put(0, "a/b", 1)
    sim.run_until_converged()
    assert sim.tables_equal()


@pytest.mark.parametrize(
    "layout,want",
    [("packed", "packed-loop"), ("rank1", "packed-loop"),
     ("dense", "dense-loop")],
)
def test_live_sim_mesh_spmd_row(layout, want):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device mesh")
    sim = PeerNetworkSim(
        64, capacity=256, topology="ring", layout=layout,
        mesh_devices=len(jax.devices()), use_shard_map=True,
    )
    name, _ = sim._convergence_strategy()
    assert name == want
    assert sim._gossip_mesh() is not None  # the loop body is shard_map
    sim.put(0, "a/b", 1)
    sim.run_until_converged()
    assert sim.tables_equal()
