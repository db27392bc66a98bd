"""K4 and K5 Smith-Waterman verification; counterpart of fandom_search_tpu/ops/smith_waterman.py.

``sw_normalized`` routes by ``cfg.sw_variant`` as the JAX package's
``sw_normalized_pallas`` does: "wide", "exitw" and "slide" (the TPU's
transposed kernel) go to K4, ``sw_wide`` (``csrc/smith_waterman.cu``,
eight lanes per pair, rows skewed over them); "fast", "r2" and "dyn"
(the TPU's lane-major kernel) go to K5, ``sw_lane``
(``csrc/smith_waterman_lane.cu``).  K5 has two routes that give the same
bits, chosen on the host from the parameters and the operand widths
(``i16_route``): the packed route (``fs_sw_lane_i16``, two pairs a 32-bit
register in int16 halves on Hopper's DPX instructions, the JAX kernel's
``state="i16"``) when the parameters are integers small enough that no
value can leave int16, else the f32 route (``fs_sw_lane``, one warp per
pair along the anti-diagonals).  Both kernels take any LB: segments wider
than 64 columns run in strips of 64, the strip's last column kept in a
scratch buffer that the wrapper allocates.  Every variant computes one
function — the kernels are exact, where JAX's "exitw" may lower scores
below the threshold — so CPU tensors take the one plain version,
``sw_normalized_plain``; ``sw_normalized_i16_plain`` is the packed
route's integer twin, for the tests.  Tokens travel as int32 bit
patterns.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from fandom_search_tpu_torch.config import SearchConfig
from fandom_search_tpu_torch.ops import _cuda

# widest segment a kernel covers in one pass; wider ones run in strips
# and need a scratch of strip-end columns, [B, 2, max(LA, LB)] f32 or, on
# K5's packed route, [ceil(B / 2), 2, max(LA, LB)] int32 (K4 and the packed
# route put the longer of a pair's two sequences along the columns)
_STRIP = 64
LANE_VARIANTS = ("fast", "r2", "dyn")
I16_MAX = 32767


def i16_route(match: float, mismatch: float, gap: float, la: int, lb: int) -> bool:
    """Whether K5's packed route gives the f32 DP's bits for these
    parameters and operand widths: the three parameters, rounded to f32,
    are integers, and max(|match|, |mismatch|, |gap|) * (LA + LB + 1) <=
    32767, so no H value and no sum before a max can leave int16.  Reads
    Python numbers and shapes only: no device sync."""
    ps = [float(np.float32(x)) for x in (match, mismatch, gap)]
    if not all(math.isfinite(x) and x == int(x) for x in ps):
        return False
    return max(abs(x) for x in ps) * (la + lb + 1) <= I16_MAX


@functools.lru_cache(maxsize=64)
def _lane_plan(match: float, mismatch: float, gap: float, la: int, lb: int):
    """(symbol, scoring arguments, packed) of K5's route, kept per
    parameters and widths: the predicate's f32 roundings cost more host
    time than the short kernel takes on the card."""
    if i16_route(match, mismatch, gap, la, lb):
        return "fs_sw_lane_i16", tuple(int(np.float32(v)) for v in (match, mismatch, gap)), True
    return "fs_sw_lane", (match, mismatch, gap), False


def sw_normalized_plain(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                        len_b: torch.Tensor, match: float, mismatch: float,
                        gap: float) -> torch.Tensor:
    """Anti-diagonal wavefront in plain PyTorch, the same cell operations
    as ``_sw_best_jnp`` (fandom_search_tpu/ops/smith_waterman.py:166)."""
    bsz, la = a.shape
    lb = b.shape[1]
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    # f32-rounded scalars: every cell is computed in f32, as in JAX
    match, mismatch, gap = (float(np.float32(x)) for x in (match, mismatch, gap))
    best = torch.zeros((bsz,), **f32)
    if la > 0 and lb > 0 and bsz > 0:
        j_ids = torch.arange(lb, device=dev)[None, :]
        valid_j = j_ids < len_b[:, None]
        h_prev = torch.zeros((bsz, lb), **f32)
        h_pp = torch.zeros((bsz, lb), **f32)
        a_diag = torch.full((bsz, lb), -1, dtype=torch.int32, device=dev)
        best_j = torch.zeros((bsz, lb), **f32)
        zero_col = torch.zeros((bsz, 1), dtype=torch.int32, device=dev)
        for d in range(la + lb - 1):
            # a_diag[:, j] holds a[:, d - j]
            inject = a[:, d : d + 1] if d < la else zero_col
            a_diag = torch.cat([inject, a_diag[:, :-1]], dim=1)
            i_ids = d - j_ids
            valid = (i_ids >= 0) & (i_ids < len_a[:, None]) & valid_j
            sub = torch.where(a_diag == b, match, mismatch)
            h = torch.maximum(
                F.pad(h_pp, (1, 0))[:, :-1] + sub,
                torch.maximum(F.pad(h_prev, (1, 0))[:, :-1], h_prev) + gap,
            )
            h = torch.clamp_min(h, 0.0)
            h = torch.where(valid, h, 0.0)
            best_j = torch.maximum(best_j, h)
            h_pp, h_prev = h_prev, h
        best = best_j.max(dim=1).values
    denom = torch.clamp_min(torch.minimum(len_a, len_b), 1).float() * match
    return best / denom


def sw_normalized_i16_plain(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                            len_b: torch.Tensor, match: float, mismatch: float,
                            gap: float) -> torch.Tensor:
    """The packed route's arithmetic in plain PyTorch: the same DP in int16
    tensors with the integer parameters, every cell of the LA x LB matrix
    computed and the cells past a pair's lengths left out of its best (a
    valid cell never reads one); then best / (match * max(1, min(len_a,
    len_b))) in f32.  Only for parameters that ``i16_route`` admits."""
    bsz, la = a.shape
    lb = b.shape[1]
    if not i16_route(match, mismatch, gap, la, lb):
        raise ValueError(f"the packed route does not take match {match}, mismatch "
                         f"{mismatch}, gap {gap} at LA {la}, LB {lb}")
    dev = a.device
    i16 = dict(dtype=torch.int16, device=dev)
    m, x, g = (torch.tensor(int(np.float32(v)), **i16) for v in (match, mismatch, gap))
    best = torch.zeros((bsz,), **i16)
    if la > 0 and lb > 0 and bsz > 0:
        j_ids = torch.arange(lb, device=dev)[None, :]
        col_ok = j_ids < len_b.clamp(0, lb)[:, None]
        na = len_a.clamp(0, la)[:, None]
        h_prev = torch.zeros((bsz, lb), **i16)
        h_pp = torch.zeros((bsz, lb), **i16)
        a_diag = torch.zeros((bsz, lb), dtype=torch.int32, device=dev)
        best_j = torch.zeros((bsz, lb), **i16)
        zero_col = torch.zeros((bsz, 1), **i16)
        zero_tok = torch.zeros((bsz, 1), dtype=torch.int32, device=dev)
        for d in range(la + lb - 1):
            inject = a[:, d : d + 1] if d < la else zero_tok
            a_diag = torch.cat([inject, a_diag[:, :-1]], dim=1)    # a[:, d - j]
            i_ids = d - j_ids
            sub = torch.where(a_diag == b, m, x)
            diag = torch.cat([zero_col, h_pp[:, :-1]], dim=1)
            left = torch.cat([zero_col, h_prev[:, :-1]], dim=1)
            p = torch.maximum(h_prev + g, diag + sub)
            h = torch.clamp_min(torch.maximum(left + g, p), 0)
            h = torch.where((i_ids >= 0) & (i_ids < la), h, 0)    # cells of the matrix
            best_j = torch.maximum(best_j, torch.where((i_ids < na) & col_ok, h, 0))
            h_pp, h_prev = h_prev, h
        best = best_j.max(dim=1).values
    denom = torch.clamp_min(torch.minimum(len_a, len_b), 1).float() * float(np.float32(match))
    return best.float() / denom


def _check(a, b, len_a, len_b):
    _cuda.require(a.dtype == torch.int32 and a.dim() == 2,
                  f"a must be int32 [B, LA], got {a.dtype} {tuple(a.shape)}")
    bsz = a.shape[0]
    _cuda.require(b.dtype == torch.int32 and b.dim() == 2 and b.shape[0] == bsz,
                  f"b must be int32 [{bsz}, LB], got {b.dtype} {tuple(b.shape)}")
    for name, t in (("len_a", len_a), ("len_b", len_b)):
        _cuda.require(t.dtype == torch.int32 and tuple(t.shape) == (bsz,),
                      f"{name} must be int32 [{bsz}], got {t.dtype} {tuple(t.shape)}")


def _launch(symbol: str, a, b, len_a, len_b, scratch_rows: int, scratch_dtype, params):
    """One launch of ``symbol`` on CUDA tensors; returns (scores, whether
    it launched).  The scratch of strip-end columns is [scratch_rows, 2,
    max(LA, LB)] when max(LA, LB) > 64."""
    bsz, la = a.shape
    lb = b.shape[1]
    _cuda.require(all(t.is_contiguous() for t in (a, b, len_a, len_b)),
                  "a, b, len_a and len_b must be contiguous")
    out = torch.empty((bsz,), dtype=torch.float32, device=a.device)
    if bsz == 0:
        return out, False
    lmax = max(la, lb)
    scratch = (torch.empty((scratch_rows, 2, lmax), dtype=scratch_dtype, device=a.device)
               if lmax > _STRIP else None)
    rc = getattr(_cuda.library(), symbol)(
        a.data_ptr(), b.data_ptr(), len_a.data_ptr(), len_b.data_ptr(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), bsz, la, lb,
        *params, _cuda.stream_ptr(a.device),
    )
    _cuda.check(rc, symbol)
    return out, True


def _plain(a, b, len_a, len_b, cfg: SearchConfig):
    return sw_normalized_plain(a, b, len_a, len_b, cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap)


def sw_wide(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
            len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """K4, eight lanes per pair (the JAX package's "wide" family)."""
    _check(a, b, len_a, len_b)
    if _cuda.on_cpu(a, b, len_a, len_b):
        return _plain(a, b, len_a, len_b, cfg)
    params = (cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap)
    out, launched = _launch("fs_sw", a, b, len_a, len_b, a.shape[0], torch.float32, params)
    sw_wide.launches += launched
    return out


def sw_lane(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
            len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """K5 (the JAX package's lane-major family): the packed route where
    ``i16_route`` admits the parameters, else the f32 route.  Both count
    in ``launches``, each also in its own ``launches_i16`` or
    ``launches_f32``."""
    _check(a, b, len_a, len_b)
    if _cuda.on_cpu(a, b, len_a, len_b):
        return _plain(a, b, len_a, len_b, cfg)
    bsz, la = a.shape
    symbol, params, packed = _lane_plan(cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap, la,
                                        b.shape[1])
    if packed:
        out, launched = _launch(symbol, a, b, len_a, len_b, (bsz + 1) // 2, torch.int32, params)
        sw_lane.launches_i16 += launched
    else:
        out, launched = _launch(symbol, a, b, len_a, len_b, bsz, torch.float32, params)
        sw_lane.launches_f32 += launched
    sw_lane.launches += launched
    return out


sw_wide.launches = 0
sw_lane.launches = 0
sw_lane.launches_i16 = 0
sw_lane.launches_f32 = 0


def sw_normalized(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                  len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """int32 a [B, LA], b [B, LB], len_a/len_b [B] -> f32 [B]:
    best local alignment / (match * max(1, min(len_a, len_b))), through
    K5 for ``cfg.sw_variant`` in fast/r2/dyn and K4 otherwise."""
    fn = sw_lane if cfg.sw_variant in LANE_VARIANTS else sw_wide
    return fn(a, b, len_a, len_b, cfg)
