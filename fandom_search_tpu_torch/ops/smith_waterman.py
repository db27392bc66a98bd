"""K4 and K5 Smith-Waterman verification; counterpart of fandom_search_tpu/ops/smith_waterman.py.

``sw_normalized`` routes by ``cfg.sw_variant`` as the JAX package's
``sw_normalized_pallas`` does: "wide", "exitw" and "slide" (the TPU's
transposed kernel) go to K4, ``sw_wide`` (``csrc/smith_waterman.cu``,
eight lanes per pair, rows skewed over them); "fast", "r2" and "dyn"
(the TPU's lane-major kernel) go to K5, ``sw_lane``
(``csrc/smith_waterman_lane.cu``, one warp per pair along the
anti-diagonals).  Both take any LB: segments wider than 64 columns run
in strips of 64, the strip's last column kept in a scratch buffer that
the wrapper allocates.  Every variant computes one function — both kernels are
exact, where JAX's "exitw" may lower scores below the threshold — so
CPU tensors take the one plain version, ``sw_normalized_plain``.
Tokens travel as int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fandom_search_tpu_torch.config import SearchConfig
from fandom_search_tpu_torch.ops import _cuda

# widest segment a kernel covers in one pass; wider ones run in strips
# and need the [B, 2, max(LA, LB)] f32 scratch of strip-end columns (K4
# puts the longer of a pair's two sequences along the columns)
_STRIP = 64
LANE_VARIANTS = ("fast", "r2", "dyn")


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


def _run(symbol: str, a, b, len_a, len_b, cfg: SearchConfig):
    """Checks, then the plain version (CPU tensors) or one launch of
    ``symbol`` (CUDA tensors); returns (scores, whether it launched)."""
    _cuda.require(a.dtype == torch.int32 and a.dim() == 2,
                  f"a must be int32 [B, LA], got {a.dtype} {tuple(a.shape)}")
    bsz = a.shape[0]
    _cuda.require(b.dtype == torch.int32 and b.dim() == 2 and b.shape[0] == bsz,
                  f"b must be int32 [{bsz}, LB], got {b.dtype} {tuple(b.shape)}")
    for name, t in (("len_a", len_a), ("len_b", len_b)):
        _cuda.require(t.dtype == torch.int32 and tuple(t.shape) == (bsz,),
                      f"{name} must be int32 [{bsz}], got {t.dtype} {tuple(t.shape)}")
    if _cuda.on_cpu(a, b, len_a, len_b):
        return sw_normalized_plain(
            a, b, len_a, len_b, cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap
        ), False
    la, lb = a.shape[1], b.shape[1]
    _cuda.require(all(t.is_contiguous() for t in (a, b, len_a, len_b)),
                  "a, b, len_a and len_b must be contiguous")
    out = torch.empty((bsz,), dtype=torch.float32, device=a.device)
    if bsz == 0:
        return out, False
    lmax = max(la, lb)
    scratch = (torch.empty((bsz, 2, lmax), dtype=torch.float32, device=a.device)
               if lmax > _STRIP else None)
    rc = getattr(_cuda.library(), symbol)(
        a.data_ptr(), b.data_ptr(), len_a.data_ptr(), len_b.data_ptr(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), bsz, la, lb,
        cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap,
        _cuda.stream_ptr(a.device),
    )
    _cuda.check(rc, symbol)
    return out, True


def sw_wide(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
            len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """K4, eight lanes per pair (the JAX package's "wide" family)."""
    out, launched = _run("fs_sw", a, b, len_a, len_b, cfg)
    sw_wide.launches += launched
    return out


def sw_lane(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
            len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """K5, one warp per pair (the JAX package's lane-major family)."""
    out, launched = _run("fs_sw_lane", a, b, len_a, len_b, cfg)
    sw_lane.launches += launched
    return out


sw_wide.launches = 0
sw_lane.launches = 0


def sw_normalized(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                  len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """int32 a [B, LA], b [B, LB], len_a/len_b [B] -> f32 [B]:
    best local alignment / (match * max(1, min(len_a, len_b))), through
    K5 for ``cfg.sw_variant`` in fast/r2/dyn and K4 otherwise."""
    fn = sw_lane if cfg.sw_variant in LANE_VARIANTS else sw_wide
    return fn(a, b, len_a, len_b, cfg)
