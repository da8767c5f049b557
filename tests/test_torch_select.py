"""select_block of the port against the JAX package's, bit for bit on
(w, slot_ok, b_hi, b_lo): tie order decides which violators enter W, so
the port must reproduce lax.top_k's lowest-index-first order, its float
total order (+0.0 above -0.0) and its -inf fillers of a short side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu_torch.solver import block as tblock


def _cases():
    rng = np.random.default_rng(21)
    n, c = 500, 2.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    out = {}
    alpha = rng.choice([0.0, c, 0.5, 1.1], size=n).astype(np.float32)
    out["random"] = (rng.normal(size=n).astype(np.float32), alpha, y, c)
    # Heavy ties: f takes five values, signed zeros among them.
    out["ties"] = (rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 1.0],
                                       np.float32), size=n), alpha, y, c)
    # Short I_up side: nearly every point sits where it is in I_low only,
    # so the up half is padded with -inf fillers (indices lowest first).
    a_short = np.where(y > 0, c, 0.0).astype(np.float32)
    a_short[:7] = 0.5
    out["short_up"] = (rng.normal(size=n).astype(np.float32), a_short, y, c)
    # Interior points in both halves (the duplicate-slot mask) and
    # class-weighted bounds.
    a_int = (rng.random(n) * 0.9).astype(np.float32)
    out["interior_weighted"] = (rng.normal(size=n).astype(np.float32), a_int,
                                y, (1.0, 0.6))
    # The start point: alpha = 0, f = -y (first round of every solve).
    out["start"] = ((-y).astype(np.float32), np.zeros(n, np.float32), y, c)
    return out


CASES = _cases()


@pytest.mark.parametrize("q", [2, 64, 100, 256])
@pytest.mark.parametrize("rule", ["mvp", "second_order"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_block_bitwise(case, rule, q):
    f, alpha, y, c = CASES[case]
    jw, jok, jbh, jbl = jblock.select_block(
        jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(y), c, q, rule=rule)
    tw, tok, tbh, tbl = tblock.select_block(
        torch.as_tensor(f), torch.as_tensor(alpha), torch.as_tensor(y), c, q,
        rule=rule)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    for t_v, j_v in ((tbh, jbh), (tbl, jbl)):
        assert np.float32(t_v.numpy()).view(np.int32) == \
            np.float32(np.asarray(j_v)).view(np.int32)


def test_short_side_really_has_fillers():
    f, alpha, y, c = CASES["short_up"]
    _, ok, _, _ = tblock.select_block(torch.as_tensor(f),
                                      torch.as_tensor(alpha),
                                      torch.as_tensor(y), c, 64)
    assert not bool(ok[:32].all()) and bool(ok[:7].all())


def test_combine_halves_matches_jax():
    up = np.array([4, 9, 2, 7], np.int32)
    up_ok = np.array([True, True, False, True])
    low = np.array([9, 2, 5, 7], np.int32)
    low_ok = np.array([True, True, True, False])
    jw, jok = jblock.combine_halves(*map(jnp.asarray, (up, up_ok, low, low_ok)))
    tw, tok = tblock.combine_halves(*map(torch.as_tensor,
                                         (up, up_ok, low, low_ok)))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # A filler up slot (2, not live) must not hide the live low 2.
    assert tok.tolist() == [True, True, False, True, False, True, True, False]


def test_nu_selection_is_not_ported():
    """select_block(rule="nu") is JAX's bit for bit. (The name dates from
    when the port refused the nu rule; tests/test_torch_nu.py holds
    every case.)"""
    f, alpha, y, c = CASES["random"]
    jw, jok, jbh, jbl = jblock.select_block(
        jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(y), c, 8, rule="nu")
    tw, tok, tbh, tbl = tblock.select_block(
        torch.as_tensor(f), torch.as_tensor(alpha), torch.as_tensor(y), c, 8,
        rule="nu")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert float(tbh) == float(jbh) and float(tbl) == float(jbl)
