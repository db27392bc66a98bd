"""K3 inclusive int32 prefix scan; counterpart of fandom_search_tpu/ops/scan.py.

``scan1d_i32`` launches ``csrc/scan.cu`` on CUDA tensors, at every size,
and runs ``scan1d_i32_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from fandom_search_tpu_torch.ops import _cuda

_OPS = {"add": 0, "max": 1}
_CHUNK = 1024  # elements per block of the kernel's first pass


def scan1d_i32_plain(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    if op == "add":
        return torch.cumsum(x, 0, dtype=torch.int32)
    return torch.cummax(x, 0).values


def scan1d_i32(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Inclusive 1-D scan of an int32 vector: "add" (cumsum) or "max"
    (cummax).  The add wraps mod 2^32."""
    if op not in _OPS:
        raise ValueError(f"op must be 'add' or 'max', got {op!r}")
    _cuda.require(x.dtype == torch.int32 and x.dim() == 1,
                  f"x must be int32 [N], got {x.dtype} {tuple(x.shape)}")
    if _cuda.on_cpu(x):
        return scan1d_i32_plain(x, op)
    _cuda.require(x.is_contiguous(), "x must be contiguous")
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    totals = torch.empty((-(-n // _CHUNK),), dtype=torch.int32, device=x.device)
    lib = _cuda.library()
    rc = lib.fs_scan(
        x.data_ptr(), out.data_ptr(), totals.data_ptr(), n, _OPS[op],
        _cuda.stream_ptr(x.device),
    )
    _cuda.check(rc, "fs_scan")
    scan1d_i32.launches += 1
    return out


scan1d_i32.launches = 0
