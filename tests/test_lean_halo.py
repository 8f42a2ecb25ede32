"""Lean gossip rounds (the four value-key arrays only): at large and
small P they must match a numpy oracle (4-key merges + counts) and the
full-metadata round's values, and leave writer/ctr/tick untouched."""

import numpy as np
import pytest

import jax.numpy as jnp

from bullet_tpu.ops.merge import TableState
from bullet_tpu.parallel.gossip import gossip_round_chain, gossip_round_ring


def lean_np(t, wrap):
    keys = [np.asarray(getattr(t, f)) for f in ("cls", "khi", "klo", "vid")]

    def merge(a, b):
        gt = np.zeros_like(a[0], dtype=bool)
        eq = np.ones_like(a[0], dtype=bool)
        for x, y in zip(a, b):
            gt |= eq & (y > x)
            eq &= x == y
        return [np.where(gt, y, x) for x, y in zip(a, b)], gt.sum()

    p = keys[0].shape[0]

    def shift(arrs, d):
        out = [np.roll(x, d, axis=0) for x in arrs]
        if not wrap:
            edge = 0 if d == 1 else p - 1
            out = [x.copy() for x in out]
            for x in out:
                x[edge, :] = 0
        return out

    m1, c1 = merge(keys, shift(keys, 1))
    m2, c2 = merge(m1, shift(keys, -1))
    return m2, c1 + c2


def random_table(p, n, seed=0):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return jnp.asarray(rng.integers(lo, hi, (p, n), dtype=np.int32))

    return TableState(
        arr(0, 4), arr(-50, 50), arr(-50, 50), arr(0, 30), arr(0, p), arr(0, 9), arr(0, 5)
    )


@pytest.mark.parametrize("shape", [(2048, 128), (1536, 256), (1024, 256), (16, 128)])
@pytest.mark.parametrize("wrap", [True, False])
def test_lean_matches_oracle_and_xla_values(shape, wrap):
    p, n = shape
    t = random_table(p, n)
    exp_keys, exp_count = lean_np(t, wrap)
    round_fn = gossip_round_ring if wrap else gossip_round_chain
    ker, ck = round_fn(t, "reference", lean=True)
    for e, name in zip(exp_keys, ("cls", "khi", "klo", "vid")):
        np.testing.assert_array_equal(e, np.asarray(getattr(ker, name)))
    assert int(ck) == int(exp_count)
    ref, _ = (gossip_round_ring if wrap else gossip_round_chain)(t, "reference")
    for name in ("cls", "khi", "klo", "vid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, name)), np.asarray(getattr(ker, name))
        )
    # metadata untouched by lean
    for name in ("writer", "ctr", "tick"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t, name)), np.asarray(getattr(ker, name))
        )
