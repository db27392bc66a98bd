"""Build, load and bind the CUDA kernels in ``csrc/`` (nvcc + ctypes).

All ``csrc/*.cu`` compile with ONE nvcc call into
``build/libfs_kernels.so``, a plain C interface for ``sm_90a``.  The
build runs at first CUDA use and is reused while a stamp file holds the
sources' hash.  Every entry point launches on the caller's stream,
allocates nothing and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB_NAME = "libfs_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    # tokens, mults, out, m, n, dim, stream
    "fs_embed": [_P, _P, _P, _L, _I, _I, _P],
    # q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, stream
    "fs_topk": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _P],
    # fs_topk's arguments, then part (int64 [splits, nq, k]) and splits,
    # then the stream
    "fs_topk_wgmma": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _P, _I, _P],
    # the same arguments as fs_topk (min_keep_i >= 1)
    "fs_topk_rows": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _P],
    # x, out, scratch, n, op (0 add / 1 max), scratch words, stream
    "fs_scan": [_P, _P, _P, _L, _I, _I, _P],
    # mask, out, scratch, n, size, scratch words, stream
    "fs_compact": [_P, _P, _P, _L, _I, _I, _P],
    # a, b, len_a, len_b, out, scratch, bsz, la, lb, match, mismatch, gap,
    # stream
    "fs_sw": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _P],
    # the same arguments as fs_sw
    "fs_sw_lane": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _P],
    # fs_sw's arguments with match, mismatch and gap as integers
    "fs_sw_lane_i16": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # q, codes_t, vals, idx, scratch, scratch_rows, nq, words, stride,
    # ns_valid, r, bits, h_max, route (0 s8 / 1 b1 mma), stream
    "fs_hamming_topk": [_P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first "
        "use and need the CUDA toolkit"
    )


def build(force: bool = False) -> float:
    """Compile csrc/*.cu into build/libfs_kernels.so if stale.

    Returns the seconds nvcc took (0.0 when the stamp was current).
    """
    so = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha256")
    digest = _source_hash()
    if (not force and so.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", str(tmp),
        *[str(f) for f in sorted(CSRC.glob("*.cu"))],
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)
    stamp.write_text(digest)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(BUILD / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fs_error_string.argtypes = [_I]
            lib.fs_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version),
    False when all lie on one CUDA device (launch the kernel); raises on
    any other mix, so a CUDA tensor never reaches a plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        import torch

        # kernels launch on the current device's stream
        if dev.index != torch.cuda.current_device():
            raise ValueError(
                f"tensors on {dev}, but the current device is "
                f"cuda:{torch.cuda.current_device()}"
            )
        return False
    raise ValueError(f"unsupported device {dev}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        name = library().fs_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")
