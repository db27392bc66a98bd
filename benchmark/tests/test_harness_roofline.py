"""The rooflines' operation and byte counts against hand counts."""

import pytest

from benchmark.harness import roofline as R


def test_k2_counts_by_hand():
    # 4 query rows x 3 script rows x dim 128: 2 * 4 * 3 * 128 = 3,072
    # operations; bytes 4*128 + 3*128 + 4 * 2 * (4 + 4) = 960
    assert R.k2_bound_s(4, 3, 128, 2) == pytest.approx(max(960 / R.HBM_BYTES_S,
                                                           3072 / R.INT8_OPS_S))
    # the engine's shape: 2^20 x 2^20 at dim 128 is bound by operations
    ops = 2.0 * 2**20 * 2**20 * 128
    assert R.k2_bound_s(2**20, 2**20, 128, 10) == pytest.approx(ops / 1.979e15)
    assert 0.142 < R.k2_bound_s(2**20, 2**20, 128, 10) < 0.143
    # no row needed, or a mesh's shard past the script's end: no time
    assert R.k2_bound_s(0, 3, 128, 2) == 0.0 == R.k2_bound_s(4, 0, 128, 2)


def test_k6_counts_by_hand():
    # 4 query rows x 3 script columns at 256 bits, R 5: 2 * 4 * 3 * 256 =
    # 6,144 operations; bytes (4 + 3) * 256 / 8 + 4 * 5 * (4 + 4) = 384,
    # which bound it
    assert R.B1_OPS_S == 8 * R.INT8_OPS_S
    assert R.k6_bound_s(4, 3, 256, 5) == pytest.approx(384 / R.HBM_BYTES_S)
    assert 384 / R.HBM_BYTES_S > 6144 / R.B1_OPS_S
    # the engine's shape, 2^20 x 19,033 at 1,024 bits and R 256, is bound
    # by operations at the 1-bit rate: 2.58 ms, an eighth of the 20.65 ms
    # the int8 rate gives
    ops = 2.0 * 2**20 * 19033 * 1024
    assert R.k6_bound_s(2**20, 19033, 1024, 256) == pytest.approx(ops / (8 * 1.979e15))
    assert 2.58e-3 < R.k6_bound_s(2**20, 19033, 1024, 256) < 2.59e-3
    assert 20.65e-3 < ops / R.INT8_OPS_S < 20.66e-3
    # a few columns and R 256: the bytes bound it, mostly the R-lists written
    nbytes = 2**20 * 128 + 64 * 128 + 2**20 * 256 * 8
    assert R.k6_bound_s(2**20, 64, 1024, 256) == pytest.approx(nbytes / 3.35e12)
    # no row needed, or no valid script column: no time
    assert R.k6_bound_s(0, 3, 256, 5) == 0.0 == R.k6_bound_s(4, 0, 256, 5)


def test_k4_counts_by_hand():
    # two pairs of lengths (3, 4) and (2, 5): 12 + 10 = 22 cells, 14
    # tokens; packed at 8.5625 / 2 instructions a cell
    t = R.k4_bound_s(cells=22, tokens=14, pairs=2, packed=True)
    assert t == pytest.approx(max((14 * 4 + 2 * 12) / R.HBM_BYTES_S,
                                  22 * 4.28125 / (132 * 64 * 1.98e9)))
    assert R.k4_bound_s(22, 14, 2, False) == pytest.approx(
        max(80 / R.HBM_BYTES_S, 22 * 6 / R.INT32_OPS_S))


def test_packed_route_rule():
    assert R.sw_packed(2.0, -1.0, -1.0, 64, 64)
    assert not R.sw_packed(2.5, -1.25, -0.75, 64, 64)
    assert not R.sw_packed(200.0, -1.0, -1.0, 64, 200)
