"""K5's packed route: its route predicate, its integer twin and its routing.

Tolerance: 0.  The packed route computes the f32 Smith-Waterman DP in
int16 halfwords; for the parameters ``i16_route`` admits every DP value
is an integer inside int16, so the integer twin
(``sw_normalized_i16_plain``) must equal the JAX package's
``state="i16"`` lane-major kernel in interpret mode, its f32 kernel and
``sw_normalized_plain`` bit for bit (np.array_equal).  The CUDA kernels
themselves run on the card (``chip_smoke.py``); here a fake library
checks which symbol each configuration reaches, with which arguments.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fandom_search_tpu.config import SearchConfig
from fandom_search_tpu.ops.smith_waterman import sw_normalized_pallas
from fandom_search_tpu_torch.config import SearchConfig as PortSearchConfig
from fandom_search_tpu_torch.ops import _cuda
from fandom_search_tpu_torch.ops import smith_waterman as port_sw
from fandom_search_tpu_torch.ops.smith_waterman import (
    i16_route,
    sw_normalized,
    sw_normalized_i16_plain,
    sw_normalized_plain,
)

CFG = SearchConfig()
PCFG = PortSearchConfig()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("params,la,lb,packed", [
    ((2.0, -1.0, -1.0), 64, 64, True),           # the engine's defaults
    ((2.5, -1.25, -0.75), 64, 64, False),        # non-integral
    ((2.0, -1.0, -0.5), 64, 64, False),          # one non-integral
    ((254.0, -1.0, -1.0), 64, 64, True),         # 254 * 129 = 32766
    ((255.0, -1.0, -1.0), 64, 64, False),        # 255 * 129 = 32895
    ((2.0, -1.0, -254.0), 64, 64, True),         # the rule reads |gap| too
    ((2.0, 255.0, -1.0), 64, 64, False),         # and mismatch
    ((108.0, -1.0, -1.0), 100, 200, True),       # 108 * 301 = 32508
    ((109.0, -1.0, -1.0), 100, 200, False),      # 109 * 301 = 32809
    ((2.0, -1.0, -1.0), 64, 200, True),          # LB 200 at the defaults
    ((3.0, 2.0, 1.0), 64, 64, True),             # positive mismatch and gap
    ((2.0000000001, -1.0, -1.0), 64, 64, True),  # an integer once rounded to f32
    ((float("inf"), -1.0, -1.0), 64, 64, False),
    ((float("nan"), -1.0, -1.0), 64, 64, False),
])
def test_i16_route_predicate(params, la, lb, packed):
    assert i16_route(*params, la, lb) is packed


def _i16_world(rng, bsz, w=64, mlt=64, vocab=40):
    """The world of tests/test_smith_waterman.py::test_i16_state_matches_f32."""
    a = rng.integers(1, vocab, size=(bsz, w)).astype(np.uint32)
    b = rng.integers(1, vocab, size=(bsz, mlt)).astype(np.uint32)
    la = rng.integers(0, w + 1, size=bsz).astype(np.int32)
    lb = rng.integers(1, mlt + 1, size=bsz).astype(np.int32)
    return a, b, la, lb


def _three_ways(a, b, la, lb, match, mismatch, gap):
    """(integer twin, f32 plain, JAX state="i16" fast kernel in interpret mode)."""
    twin = sw_normalized_i16_plain(_t(a), _t(b), _t(la), _t(lb), match, mismatch, gap).numpy()
    plain = sw_normalized_plain(_t(a), _t(b), _t(la), _t(lb), match, mismatch, gap).numpy()
    cfg = dataclasses.replace(CFG, sw_match=match, sw_mismatch=mismatch, sw_gap=gap)
    jax_i16 = np.asarray(sw_normalized_pallas(a, b, la, lb, cfg, interpret=True,
                                              state="i16", variant="fast"))
    return twin, plain, jax_i16


def test_i16_twin_matches_jax_i16_kernel_on_its_world(rng):
    a, b, la, lb = _i16_world(rng, 256)
    twin, plain, jax_i16 = _three_ways(a, b, la, lb, 2.0, -1.0, -1.0)
    assert np.array_equal(twin, jax_i16)
    assert np.array_equal(twin, plain)
    f32 = np.asarray(sw_normalized_pallas(a, b, la, lb, CFG, interpret=True,
                                          state="f32", variant="fast"))
    assert np.array_equal(twin, f32)


@pytest.mark.parametrize("match,mismatch,gap", [
    (254.0, -1.0, -1.0),     # H up to 254 * 64 = 16256; the rule's limit at 64 x 64
    (254.0, -254.0, -254.0),
    (3.0, 2.0, 1.0),         # positive mismatch and gap: no sign to lean on
])
def test_i16_twin_matches_jax_i16_kernel_near_the_limit(rng, match, mismatch, gap):
    a, b, la, lb = _i16_world(rng, 64, vocab=4)
    a[:8], la[:8], lb[:8] = b[:8], 64, 64   # whole pairs equal
    twin, plain, jax_i16 = _three_ways(a, b, la, lb, match, mismatch, gap)
    assert np.array_equal(twin, jax_i16)
    assert np.array_equal(twin, plain)
    if gap < 0:
        assert (twin[:8] == 1.0).all()   # whole containment: best = 254 * 64


@pytest.mark.parametrize("la,lb", [(64, 64), (23, 11), (100, 200), (64, 65), (1, 1)])
@pytest.mark.parametrize("params", [(2.0, -1.0, -1.0), (2.0, 1.0, 1.0), (5.0, -3.0, 2.0)])
def test_i16_twin_matches_plain_on_ragged_batches(rng, la, lb, params):
    """Odd B, len-0 and negative lengths, len_b past LB and unsorted pairs
    of very different lengths; positive parameters too.  (len_a past LA is
    left out: there the plain version, like the JAX DP, scores phantom rows
    of token 0 below row LA, and the kernels stop at LA; the engine clamps
    len_a to LA.)"""
    bsz = 37
    a = rng.integers(1, 6, size=(bsz, la)).astype(np.uint32)
    b = rng.integers(1, 6, size=(bsz, lb)).astype(np.uint32)
    len_a = rng.integers(-2, la + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(-2, lb + 3, size=bsz).astype(np.int32)
    len_a[0], len_b[1] = 0, 0
    twin = sw_normalized_i16_plain(_t(a), _t(b), _t(len_a), _t(len_b), *params)
    plain = sw_normalized_plain(_t(a), _t(b), _t(len_a), _t(len_b), *params)
    assert torch.equal(twin, plain)


def test_i16_twin_refuses_what_the_route_does_not_take():
    z = torch.zeros((2, 64), dtype=torch.int32)
    zl = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        sw_normalized_i16_plain(z, z, zl, zl, 2.5, -1.0, -1.0)
    with pytest.raises(ValueError):
        sw_normalized_i16_plain(z, z, zl, zl, 255.0, -1.0, -1.0)


class _FakeLib:
    def __init__(self, rc=0):
        self.calls = []
        self.args = []
        self.rc = rc

    def fs_error_string(self, rc):
        return b"cudaErrorLaunchFailure"

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.rc
        return call


@pytest.fixture
def fake(monkeypatch):
    """A fake kernel library on CPU tensors, and the (shape, dtype) of every
    torch.empty the wrapper makes."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda device: 0)
    made = []
    empty = torch.empty

    def recording_empty(shape, **kw):
        made.append((tuple(shape), kw.get("dtype")))
        return empty(shape, **kw)

    monkeypatch.setattr(port_sw.torch, "empty", recording_empty)
    return lib, made


def _counters():
    return (port_sw.sw_lane.launches, port_sw.sw_lane.launches_i16,
            port_sw.sw_lane.launches_f32, port_sw.sw_wide.launches)


@pytest.mark.parametrize("variant", ["fast", "r2", "dyn"])
@pytest.mark.parametrize("scores,symbol", [
    ({}, "fs_sw_lane_i16"),
    (dict(sw_match=3.0, sw_mismatch=2.0, sw_gap=1.0), "fs_sw_lane_i16"),
    (dict(sw_match=2.5, sw_mismatch=-1.25, sw_gap=-0.75), "fs_sw_lane"),
    (dict(sw_match=255.0), "fs_sw_lane"),
])
@pytest.mark.parametrize("bsz,lb", [(3, 64), (3, 65), (1, 200), (8, 64)])
def test_lane_variants_route_by_parameters(fake, variant, scores, symbol, bsz, lb):
    """fast/r2/dyn reach the packed symbol where i16_route admits the
    parameters (integers passed as ints), else fs_sw_lane (f32 floats);
    odd B and LB > 64 pass their shapes and a scratch of [ceil(B / 2), 2,
    LB] int32 (packed) or [B, 2, LB] f32; the counters move by route."""
    lib, made = fake
    la = 64
    cfg = dataclasses.replace(PCFG, sw_variant=variant, **scores)
    a = torch.zeros((bsz, la), dtype=torch.int32)
    b = torch.zeros((bsz, lb), dtype=torch.int32)
    ln = torch.zeros((bsz,), dtype=torch.int32)
    before = _counters()
    out = sw_normalized(a, b, ln, ln, cfg)
    assert out.shape == (bsz,) and lib.calls == [symbol]
    args = lib.args[0]
    assert args[:5] == (a.data_ptr(), b.data_ptr(), ln.data_ptr(), ln.data_ptr(), out.data_ptr())
    assert args[6:9] == (bsz, la, lb)
    packed = symbol == "fs_sw_lane_i16"
    if packed:
        want = tuple(int(v) for v in (cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap))
        assert args[9:12] == want and all(type(v) is int for v in args[9:12])
    else:
        assert args[9:12] == (cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap)
        assert all(type(v) is float for v in args[9:12])
    if lb > 64:
        rows = (bsz + 1) // 2 if packed else bsz
        assert args[5] != 0
        assert ((rows, 2, lb), torch.int32 if packed else torch.float32) in made
    else:
        assert args[5] == 0 and len(made) == 1   # the output alone
    n, n16, n32, nw = before
    assert _counters() == (n + 1, n16 + packed, n32 + (not packed), nw)


@pytest.mark.parametrize("variant", ["wide", "exitw", "slide"])
@pytest.mark.parametrize("scores", [{}, dict(sw_match=2.5, sw_mismatch=-1.25, sw_gap=-0.75)])
def test_wide_variants_never_reach_k5(fake, variant, scores):
    lib, _ = fake
    a = torch.zeros((3, 64), dtype=torch.int32)
    b = torch.zeros((3, 65), dtype=torch.int32)
    ln = torch.zeros((3,), dtype=torch.int32)
    before = _counters()
    sw_normalized(a, a, ln, ln, dataclasses.replace(PCFG, sw_variant=variant, **scores))
    sw_normalized(a, b, ln, ln, dataclasses.replace(PCFG, sw_variant=variant, **scores))
    assert lib.calls == ["fs_sw", "fs_sw"]
    n, n16, n32, nw = before
    assert _counters() == (n, n16, n32, nw + 2)


@pytest.mark.parametrize("scores", [{}, dict(sw_match=2.5)])
def test_a_failed_launch_raises_on_either_route(fake, scores):
    """No fallback: a non-zero return of either K5 symbol raises, and
    nothing else is called in its place."""
    lib, _ = fake
    lib.rc = 4
    a = torch.zeros((3, 64), dtype=torch.int32)
    ln = torch.zeros((3,), dtype=torch.int32)
    before = _counters()
    with pytest.raises(RuntimeError, match="CUDA error 4"):
        sw_normalized(a, a, ln, ln, dataclasses.replace(PCFG, sw_variant="fast", **scores))
    assert lib.calls == ["fs_sw_lane_i16" if not scores else "fs_sw_lane"]
    assert _counters() == before
