"""K4 and K5 Smith-Waterman: the port's plain version against the JAX package.

Tolerance: 0.  With the default integer scores every DP cell is an
exact small integer and the score is one f32 division, so results
compare exactly (np.array_equal) against sw_normalized_np,
sw_normalized_jnp and the interpreted Pallas kernels: "wide" (K4's
TPU kernel) and the lane-major "fast", "r2" and "dyn" (K5's).
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
from fandom_search_tpu_torch.config import SearchConfig as PortSearchConfig
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops import smith_waterman as port_sw
from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized

CFG = SearchConfig()
PCFG = PortSearchConfig()
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


def _port(a, b, len_a, len_b, cfg=PCFG):
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
    scores = dict(sw_match=3.0, sw_mismatch=-2.0, sw_gap=-0.5)
    cfg = dataclasses.replace(CFG, **scores)
    a, b, len_a, len_b = _batch(rng, 24, vocab=6)
    got = _port(a, b, len_a, len_b, dataclasses.replace(PCFG, **scores))
    assert np.array_equal(got, np.asarray(sw_normalized_jnp(a, b, len_a, len_b, cfg)))


def test_plain_sw_empty_batch_and_bad_args():
    z = torch.zeros((0, LA), dtype=torch.int32)
    zl = torch.zeros((0,), dtype=torch.int32)
    assert sw_normalized(z, z, zl, zl, PCFG).shape == (0,)
    with pytest.raises(ValueError):
        sw_normalized(z.long(), z, zl, zl, PCFG)
    with pytest.raises(ValueError):
        sw_normalized(z, z, zl.long(), zl, PCFG)


@pytest.mark.parametrize("variant", ["fast", "r2", "dyn"])
def test_plain_sw_matches_lane_major_pallas(rng, variant):
    """K5's route (sw_variant fast/r2/dyn) on the CPU equals the JAX
    package's lane-major kernel in interpret mode."""
    a, b, len_a, len_b = _batch(rng, 40)
    got = _port(a, b, len_a, len_b, dataclasses.replace(PCFG, sw_variant=variant))
    pal = sw_normalized_pallas(a, b, len_a, len_b, CFG, interpret=True,
                               variant=variant)
    assert np.array_equal(got, np.asarray(pal))
    assert np.array_equal(got, _np(a, b, len_a, len_b))


class _FakeLib:
    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return call


@pytest.mark.parametrize("variant,symbol,counter", [
    ("fast", "fs_sw_lane_i16", "sw_lane"), ("r2", "fs_sw_lane_i16", "sw_lane"),
    ("dyn", "fs_sw_lane_i16", "sw_lane"), ("wide", "fs_sw", "sw_wide"),
    ("exitw", "fs_sw", "sw_wide"), ("slide", "fs_sw", "sw_wide"),
])
def test_variant_routes_to_its_kernel(monkeypatch, variant, symbol, counter):
    """fast/r2/dyn launch K5 (its packed route at the default integral
    parameters), wide/exitw/slide launch K4; the launching wrapper's
    counter grows by one, the other's not at all.  LB = 64 needs no
    scratch; LB = 65 reaches the same kernel with a scratch of strip-end
    columns."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    a = torch.zeros((3, LA), dtype=torch.int32)
    ln = torch.zeros((3,), dtype=torch.int32)
    cfg = dataclasses.replace(PCFG, sw_variant=variant)
    before = {c: getattr(port_sw, c).launches for c in ("sw_lane", "sw_wide")}
    out = sw_normalized(a, a, ln, ln, cfg)
    assert out.shape == (3,) and lib.calls == [symbol]
    for c, n in before.items():
        assert getattr(port_sw, c).launches == n + (c == counter)
    args = lib.args[0]
    assert args[0] == a.data_ptr() and args[4] == out.data_ptr()
    assert args[5] == 0 and args[6:9] == (3, LA, LB)
    b = torch.zeros((3, 65), dtype=torch.int32)
    out = sw_normalized(a, b, ln, ln, cfg)
    assert out.shape == (3,) and lib.calls == [symbol, symbol]
    args = lib.args[1]
    assert args[1] == b.data_ptr() and args[5] != 0 and args[6:9] == (3, LA, 65)
    assert args[9:12] == (PCFG.sw_match, PCFG.sw_mismatch, PCFG.sw_gap)
    assert getattr(port_sw, counter).launches == before[counter] + 2


@pytest.mark.parametrize("lb", [65, 96, 130])
def test_plain_sw_wide_segments_match_jnp_and_pallas(rng, lb):
    """Segments wider than 64 tokens (max_line_tokens > 64, the strips
    of K4 and K5 on the card): the plain version equals _sw_best_jnp's
    batch form, the NumPy verifier and the "wide" Pallas kernel in
    interpret mode."""
    bsz, la = 20, 64
    a = rng.integers(1, 30, size=(bsz, la)).astype(np.uint32)
    b = rng.integers(1, 30, size=(bsz, lb)).astype(np.uint32)
    len_a = rng.integers(0, la + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(0, lb + 1, size=bsz).astype(np.int32)
    len_a[0], len_b[0] = la, lb
    len_b[1] = 0
    for i in range(2, bsz, 2):                 # a's words inside b, past column 64
        m = int(min(len_a[i], len_b[i] - 40)) if len_b[i] > 40 else 0
        b[i, 40 : 40 + m] = a[i, :m]
    got = _port(a, b, len_a, len_b)
    assert np.array_equal(got, _np(a, b, len_a, len_b))
    assert np.array_equal(got, np.asarray(sw_normalized_jnp(a, b, len_a, len_b, CFG)))
    pal = sw_normalized_pallas(a, b, len_a, len_b, CFG, interpret=True, variant="wide")
    assert np.array_equal(got, np.asarray(pal))
    assert (got[2::2][len_b[2::2] > 60] > 0.5).any()
