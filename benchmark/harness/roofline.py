"""Peaks of the card and the work each kernel call needs.

A kernel's roofline share is its least time (the larger of its bytes
over the memory rate and its operations over the peak rate for their
type) over the time it took.  The counts are of what the algorithm needs
at the call's shapes, whatever implements it: each input byte read once,
each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and int8 tensor-core
# operations/s (two a multiply-add)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
# 1-bit tensor-core operations/s (an AND and a popcount-add a bit pair).
# NVIDIA publishes no Hopper rate for the b1 mma; this is A100's published
# ratio, 4,992 binary against 624 int8 TOPS dense (8x: one m16n8k256 b1
# mma does the bit pairs of eight m16n8k32 s8 ones), applied to the H100's
# int8 peak.  It is taken as a ceiling: if Hopper's real 1-bit rate is
# lower, a share of it is understated, and never reads past 100%.
B1_OPS_S = 8 * INT8_OPS_S
# CUDA cores, compute capability 9.0 (CUDA C++ Programming Guide,
# "Throughput of Native Arithmetic Instructions"): 64 32-bit integer,
# compare, minimum and maximum results a clock an SM, on 132 SMs at the
# 1,980 MHz boost clock
INT32_OPS_S = 132 * 64 * 1.98e9
# One Smith-Waterman cell on the packed int16 route (two cells a 32-bit
# register): three DPX instructions, the running best and the
# substitution score, 8.5625 instructions a register of two cells.  K4
# computes the same function at these parameters and is held to it.
SW_OPS_PER_CELL_I16 = 8.5625 / 2
# The f32 cell where the parameters leave int16: four max, a compare and
# a select at the integer rate (the two adds run at twice it)
SW_OPS_PER_CELL_F32 = 6.0
I16_MAX = 32767


def bound_s(nbytes: float, ops: float, ops_rate: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / ops_rate)


def k2_bound_s(nq: int, ns: int, dim: int, k: int) -> float:
    """Distance top-k: NQ x NS int8 dots of width dim; the int8 rows of
    both sides read once, k (score f32, index int32) a row written.  A
    call that needs no row, or has no valid script row (a mesh's shard
    past the script's end), needs no time."""
    if not nq or not ns:
        return 0.0
    return bound_s(nq * dim + ns * dim + nq * k * 8, 2.0 * nq * ns * dim, INT8_OPS_S)


def k6_bound_s(nq: int, ns: int, bits: int, r: int) -> float:
    """Hamming top-R: NQ x NS code pairs of ``bits`` bits, an AND and a
    popcount-add a bit pair at the 1-bit rate (the least work of any
    route, whatever product implements it); the packed codes of both
    sides (bits / 8 bytes a row) read once, R (similarity f32, column
    int32) a row written.  A call that needs no row, or has no valid
    script column, needs no time."""
    if not nq or not ns:
        return 0.0
    return bound_s((nq + ns) * bits / 8 + nq * r * 8, 2.0 * nq * ns * bits, B1_OPS_S)


def sw_packed(match: float, mismatch: float, gap: float, la: int, lb: int) -> bool:
    """Whether integer parameters keep every DP value inside int16."""
    ps = (float(match), float(mismatch), float(gap))
    return all(p == int(p) for p in ps) and max(abs(p) for p in ps) * (la + lb + 1) <= I16_MAX


def k4_bound_s(cells: int, tokens: int, pairs: int, packed: bool) -> float:
    """Smith-Waterman over pairs: the DP cells the pairs' lengths need;
    the tokens inside those lengths (4 bytes each) and the lengths read
    once, one f32 score a pair written."""
    per_cell = SW_OPS_PER_CELL_I16 if packed else SW_OPS_PER_CELL_F32
    return bound_s(tokens * 4 + pairs * 12, per_cell * cells, INT32_OPS_S)
