"""K3 inclusive int32 prefix scan and the compaction built on it;
counterpart of fandom_search_tpu/ops/scan.py and of the JAX engine's
``nonzero_compact``.

On CUDA tensors ``scan1d_i32`` and ``nonzero_compact`` are ONE launch
each of ``csrc/scan.cu`` (a cooperative kernel); on CPU tensors they run
``scan1d_i32_plain`` and ``nonzero_compact_plain``.  Both count into
``scan1d_i32.launches``.
"""

from __future__ import annotations

import torch

from fandom_search_tpu_torch.ops import _cuda

_OPS = {"add": 0, "max": 1}
# int32 words of per-launch scratch: one per block of the cooperative
# grid (the kernel caps its grid here; an H100 holds ~1,000 blocks)
_SCRATCH_WORDS = 4096
_scratch: dict = {}


def scan1d_i32_plain(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    if op == "add":
        return torch.cumsum(x, 0, dtype=torch.int32)
    return torch.cummax(x, 0).values


def _scratch_for(device, stream: int) -> torch.Tensor:
    """The kernel's block totals, one buffer per (device, stream): the
    kernel writes every word it reads, so it needs no reset, and launches
    on one stream run in order."""
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.empty((_SCRATCH_WORDS,), dtype=torch.int32, device=device)
        _scratch[key] = buf
    return buf


def scan1d_i32(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Inclusive 1-D scan of an int32 vector: "add" (cumsum) or "max"
    (cummax).  The add wraps mod 2^32."""
    if op not in _OPS:
        raise ValueError(f"op must be 'add' or 'max', got {op!r}")
    # checks without formatting a message unless one fails: at the
    # engine's sizes the kernel takes a few microseconds, so the host
    # cost of a call is what a caller waits for
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"x must be int32 [N], got {x.dtype} {tuple(x.shape)}")
    if _cuda.on_cpu(x):
        return scan1d_i32_plain(x, op)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    stream = _cuda.stream_ptr(x.device)
    rc = _cuda.library().fs_scan(
        x.data_ptr(), out.data_ptr(), _scratch_for(x.device, stream).data_ptr(),
        n, _OPS[op], _SCRATCH_WORDS, stream,
    )
    _cuda.check(rc, "fs_scan")
    scan1d_i32.launches += 1
    return out


scan1d_i32.launches = 0


def nonzero_compact_plain(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The scan-and-scatter sequence of the JAX engine: the inclusive
    scan gives each selected entry its slot; a scatter into [size + N]
    sends every other entry to a distinct slot past ``size``, so
    destinations are unique and no sync is needed."""
    m = mask.reshape(-1)
    n = m.shape[0]
    csum = scan1d_i32_plain(m.to(torch.int32))
    src = torch.arange(n, dtype=torch.int32, device=m.device)
    sel = m.bool() & (csum <= size)
    dest = torch.where(sel, csum - 1, size + src)
    out = torch.full((size + n,), -1, dtype=torch.int32, device=m.device)
    out.scatter_(0, dest.long(), src)
    return out[:size]


def nonzero_compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Ascending indices of True entries, -1 padded to ``size`` (entries
    past ``size`` drop; callers detect overflow from a separate count).
    One K3 launch on a CUDA bool mask: index i goes to slot csum_i - 1
    when that slot is below ``size``, and slots [total, size) get -1."""
    if size < 0:
        raise ValueError(f"size ({size}) must be >= 0")
    if _cuda.on_cpu(mask):
        return nonzero_compact_plain(mask, size)
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor, got {mask.dtype}")
    out = torch.empty((size,), dtype=torch.int32, device=mask.device)
    if size == 0:
        return out
    stream = _cuda.stream_ptr(mask.device)
    rc = _cuda.library().fs_compact(
        mask.data_ptr(), out.data_ptr(), _scratch_for(mask.device, stream).data_ptr(),
        mask.numel(), size, _SCRATCH_WORDS, stream,
    )
    _cuda.check(rc, "fs_compact")
    scan1d_i32.launches += 1
    return out
