"""ctypes binding for the native tokenizer; counterpart of fandom_search_tpu/data/fast_tokenizer.py.

The C++ source is the JAX package's ``native/fastingest.cpp``, read by
path and compiled with g++ into this package's ``build/`` directory.
Without a compiler the pure-Python tokenizer runs instead; the two are
byte-for-byte equivalent.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from fandom_search_tpu_torch.data.tokenizer import Tokenized, tokenize

log = logging.getLogger(__name__)

_ABI_VERSION = 4
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_SRC = (
    Path(__file__).resolve().parents[2]
    / "fandom_search_tpu" / "native" / "fastingest.cpp"
)
_BUILD = Path(__file__).resolve().parents[1] / "build"


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    so = _BUILD / f"libfastingest_v{_ABI_VERSION}.so"
    if not so.exists():
        # unique temp name: concurrent first-use builds from several
        # processes each compile to their own file; the replace is atomic
        tmp = _BUILD / f".libfastingest_v{_ABI_VERSION}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", str(tmp), str(_SRC)]
        try:
            _BUILD.mkdir(exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native build failed (%s); using Python tokenizer", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        log.warning("native load failed (%s); using Python tokenizer", e)
        return None
    lib.fs_tokenize.restype = ctypes.c_int64
    lib.fs_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fs_abi_version.restype = ctypes.c_int32
    if lib.fs_abi_version() != _ABI_VERSION:
        log.warning("native ABI mismatch; using Python tokenizer")
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            _lib = _build_and_load()
            _lib_failed = _lib is None
    return _lib


def fast_tokenize(text: str) -> Tokenized:
    """Native-if-possible tokenization; identical output to tokenize()."""
    lib = get_lib()
    if lib is None:
        return tokenize(text)
    try:
        data = text.encode("utf-8")
    except UnicodeEncodeError:
        # lone surrogates can't round-trip through the C ABI; the Python
        # path handles them
        return tokenize(text)
    cap = max(1, len(text))
    hashes = np.empty(cap, dtype=np.uint32)
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    n = lib.fs_tokenize(
        data, len(data),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    offsets = np.stack([starts[:n], ends[:n]], axis=1).astype(np.int32)
    return Tokenized(text=text, offsets=offsets, hashes=hashes[:n].copy())


def tokenize_many(texts: Dict[str, str]) -> Dict[str, Tokenized]:
    """Parallel corpus ingestion (GIL-free native calls on a thread pool)."""
    if get_lib() is None or len(texts) < 4:
        return {k: fast_tokenize(v) for k, v in texts.items()}
    threads = min(16, os.cpu_count() or 4)
    keys = list(texts)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        results = list(ex.map(lambda k: fast_tokenize(texts[k]), keys))
    return dict(zip(keys, results))
