"""K2 fused int8 distance + top-k; counterpart of fandom_search_tpu/ops/distance_topk.py.

``topk_dot`` launches ``csrc/distance_topk.cu`` on CUDA tensors and runs
``topk_dot_plain`` on CPU tensors.  Both return, per query row, the
exact top-k of dot(q, s) / dim over script rows [0, ns_valid), ties to
the lowest column; empty slots are (NEG_INF, 0).  With a finite
``min_keep`` only scores >= min_keep enter, so a row may hold padding
where the JAX kernel would hold sub-threshold entries — entries at or
above the threshold are identical (the engine never reads the others).
"""

from __future__ import annotations

import numpy as np
import torch

from fandom_search_tpu_torch.ops import _cuda

NEG_INF = float(np.finfo(np.float32).min)

# min_keep floor in raw-dot units: far below any real score (|dot| <=
# n^2 * dim), the same floor the JAX kernel uses for -inf
_KEEP_FLOOR = -(1 << 30)
_KEY_EMPTY = -(1 << 62)
_KERNEL_DIM = 128
_KERNEL_MAX_K = 32


def min_keep_int(min_keep: float, dim: int) -> int:
    """``score >= min_keep`` as an integer test on the raw dot."""
    if not np.isfinite(min_keep):
        return _KEEP_FLOOR
    return int(min(max(int(np.ceil(min_keep * dim)), _KEEP_FLOOR), 1 << 30))


def topk_dot_plain(q: torch.Tensor, s: torch.Tensor, ns_valid: int, k: int,
                   min_keep_i: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the K2 kernel.

    Dots run as f32 matmuls, which are exact here (int8 @ int8 on the
    CPU returns int8 and overflows).  Selection packs (score, column)
    into one unique int64 key, score * ns + (ns - 1 - col), so the top-k
    of the keys is the top-k of the scores with the lowest column first
    on ties — torch.topk alone does not break ties that way.  Query rows
    are chunked so no more than ~64M keys exist at once.
    """
    nq, dim = q.shape
    dev = q.device
    vals = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    ns = int(ns_valid)
    if nq == 0 or ns == 0:
        return vals, idx
    s_t = s[:ns].float().T.contiguous()                       # [dim, ns]
    rank = (ns - 1 - torch.arange(ns, device=dev)).long()      # col -> tiebreak
    inv_dim = float(np.float32(1.0 / dim))  # the kernel's f32 multiplier
    width = max(ns, k)
    chunk = max(1, (1 << 26) // width)
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        score = (q[q0:q1].float() @ s_t).long()               # exact ints
        key = torch.where(score >= min_keep_i, score * ns + rank, _KEY_EMPTY)
        if width > ns:
            key = torch.nn.functional.pad(key, (0, width - ns), value=_KEY_EMPTY)
        top = torch.topk(key, k, dim=1).values
        empty = top == _KEY_EMPTY
        sc = torch.div(top, ns, rounding_mode="floor")
        col = ns - 1 - (top - sc * ns)
        vals[q0:q1] = torch.where(empty, NEG_INF, sc.float() * inv_dim)
        idx[q0:q1] = torch.where(empty, 0, col).int()
    return vals, idx


def topk_dot(q: torch.Tensor, s: torch.Tensor, ns_valid: int, k: int, *,
             min_keep: float = -float("inf")) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 q [NQ, dim], int8 s [NS, dim] -> (f32 vals [NQ, k], int32 idx [NQ, k]).

    ``min_keep`` (in dot/dim units) declares that the caller discards
    scores below it; leave it at -inf for the exact full top-k.
    """
    _cuda.require(q.dtype == torch.int8 and q.dim() == 2,
                  f"q must be int8 [NQ, dim], got {q.dtype} {tuple(q.shape)}")
    _cuda.require(s.dtype == torch.int8 and s.dim() == 2 and s.shape[1] == q.shape[1],
                  f"s must be int8 [NS, {q.shape[1]}], got {s.dtype} {tuple(s.shape)}")
    _cuda.require(0 <= ns_valid <= s.shape[0],
                  f"ns_valid ({ns_valid}) must lie in [0, {s.shape[0]}]")
    _cuda.require(k >= 1, f"k ({k}) must be >= 1")
    nq, dim = q.shape
    keep_i = min_keep_int(min_keep, dim)
    if _cuda.on_cpu(q, s):
        return topk_dot_plain(q, s, ns_valid, k, keep_i)
    _cuda.require(dim == _KERNEL_DIM,
                  f"the CUDA kernel takes dim {_KERNEL_DIM}, got {dim}")
    _cuda.require(k <= _KERNEL_MAX_K,
                  f"the CUDA kernel takes k <= {_KERNEL_MAX_K}, got {k}")
    _cuda.require(q.is_contiguous() and s.is_contiguous(),
                  "q and s must be contiguous")
    _cuda.require(q.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0,
                  "q and s must be 16-byte aligned")
    vals = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return vals, idx
    lib = _cuda.library()
    rc = lib.fs_topk(
        q.data_ptr(), s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        nq, int(ns_valid), dim, k, keep_i, 1.0 / dim,
        _cuda.stream_ptr(q.device),
    )
    _cuda.check(rc, "fs_topk")
    topk_dot.launches += 1
    return vals, idx


topk_dot.launches = 0
