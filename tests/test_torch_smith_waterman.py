"""K4 Smith-Waterman: the port's plain version against the JAX package.

Tolerance: 0.  With the default integer scores every DP cell is an
exact small integer and the score is one f32 division, so results
compare exactly (np.array_equal) against sw_normalized_np,
sw_normalized_jnp and the interpreted Pallas "wide" kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fandom_search_tpu.config import SearchConfig
from fandom_search_tpu.ops.smith_waterman import (
    sw_normalized_jnp,
    sw_normalized_pallas,
)
from fandom_search_tpu.search.verify_np import sw_normalized_np
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized

CFG = SearchConfig()
LA, LB = 64, 64


def _batch(rng, bsz, vocab=40):
    a = rng.integers(1, vocab, size=(bsz, LA)).astype(np.uint32)
    b = rng.integers(1, vocab, size=(bsz, LB)).astype(np.uint32)
    len_a = rng.integers(0, LA + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(0, LB + 1, size=bsz).astype(np.int32)
    len_a[:3] = 0                      # len-0 rows
    len_b[3:5] = 0
    a[5], b[5] = a[6], a[6][:LB]       # identical pairs
    len_a[5], len_b[5] = 40, 40
    for i in range(8, bsz, 5):         # planted containment
        m = int(min(len_a[i], len_b[i]))
        a[i, :m] = b[i, :m]
    return a, b, len_a, len_b


def _port(a, b, len_a, len_b, cfg=CFG):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))  # noqa: E731
    return sw_normalized(t(a), t(b), t(len_a), t(len_b), cfg).numpy()


def _np(a, b, len_a, len_b, cfg=CFG):
    return np.array([
        sw_normalized_np(a[i, : len_a[i]], b[i, : len_b[i]], cfg)
        for i in range(a.shape[0])
    ], dtype=np.float32)


def test_plain_sw_matches_numpy_jnp_and_pallas(rng):
    a, b, len_a, len_b = _batch(rng, 48)
    got = _port(a, b, len_a, len_b)
    assert got.dtype == np.float32
    assert np.array_equal(got, _np(a, b, len_a, len_b))
    assert np.array_equal(got, np.asarray(sw_normalized_jnp(a, b, len_a, len_b, CFG)))
    pal = sw_normalized_pallas(a, b, len_a, len_b, CFG, interpret=True, variant="wide")
    assert np.array_equal(got, np.asarray(pal))
    assert got[5] == 1.0 and (got[:5] == 0.0).all()


def test_plain_sw_all_padding_tile_and_ragged_widths(rng):
    # a whole 128-pair tile of len-0 rows after a ragged one
    a, b, len_a, len_b = _batch(rng, 200)
    len_a[64:] = 0
    got = _port(a, b, len_a, len_b)
    assert np.array_equal(got, np.asarray(
        sw_normalized_pallas(a, b, len_a, len_b, CFG, interpret=True, variant="wide")
    ))
    assert (got[64:] == 0.0).all()
    # narrower operands than the engine's 64 x 64
    a2, b2 = a[:, :23], b[:, :11]
    la2, lb2 = np.minimum(len_a, 23), np.minimum(len_b, 11)
    assert np.array_equal(_port(a2, b2, la2, lb2), _np(a2, b2, la2, lb2))


def test_plain_sw_other_scores(rng):
    cfg = dataclasses.replace(CFG, sw_match=3.0, sw_mismatch=-2.0, sw_gap=-0.5)
    a, b, len_a, len_b = _batch(rng, 24, vocab=6)
    got = _port(a, b, len_a, len_b, cfg)
    assert np.array_equal(got, np.asarray(sw_normalized_jnp(a, b, len_a, len_b, cfg)))


def test_plain_sw_empty_batch_and_bad_args():
    z = torch.zeros((0, LA), dtype=torch.int32)
    zl = torch.zeros((0,), dtype=torch.int32)
    assert sw_normalized(z, z, zl, zl, CFG).shape == (0,)
    with pytest.raises(ValueError):
        sw_normalized(z.long(), z, zl, zl, CFG)
    with pytest.raises(ValueError):
        sw_normalized(z, z, zl.long(), zl, CFG)
