"""K4 Smith-Waterman verification; counterpart of fandom_search_tpu/ops/smith_waterman.py.

``sw_normalized`` launches ``csrc/smith_waterman.cu`` on CUDA tensors
and runs ``sw_normalized_plain`` on CPU tensors.  Every ``sw_variant``
of the JAX package computes this one function, so the port has one
exact kernel for all of them.  Tokens travel as int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fandom_search_tpu.config import SearchConfig
from fandom_search_tpu_torch.ops import _cuda

_KERNEL_MAX_LB = 64


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


def sw_normalized(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                  len_b: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """int32 a [B, LA], b [B, LB], len_a/len_b [B] -> f32 [B]:
    best local alignment / (match * max(1, min(len_a, len_b)))."""
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
        )
    la, lb = a.shape[1], b.shape[1]
    _cuda.require(lb <= _KERNEL_MAX_LB,
                  f"the CUDA kernel takes LB <= {_KERNEL_MAX_LB}, got {lb}")
    _cuda.require(all(t.is_contiguous() for t in (a, b, len_a, len_b)),
                  "a, b, len_a and len_b must be contiguous")
    out = torch.empty((bsz,), dtype=torch.float32, device=a.device)
    if bsz == 0:
        return out
    lib = _cuda.library()
    rc = lib.fs_sw(
        a.data_ptr(), b.data_ptr(), len_a.data_ptr(), len_b.data_ptr(),
        out.data_ptr(), bsz, la, lb,
        cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap,
        _cuda.stream_ptr(a.device),
    )
    _cuda.check(rc, "fs_sw")
    sw_normalized.launches += 1
    return out


sw_normalized.launches = 0
