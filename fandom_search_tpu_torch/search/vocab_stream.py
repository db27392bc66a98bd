"""Lossless u16 vocab-id encoding of the query token stream; counterpart of fandom_search_tpu/search/vocab_stream.py.

The fused path uploads the batch's u32 token hashes, and the hashes
themselves are uniform (fmix32-finalized), so no entropy coding applies
to them directly.  Word *occurrences*, however, are Zipfian: a
<=65,535-entry table of the most frequent word hashes covers the vast
majority of token occurrences in natural text, so the stream is encoded
as u16 table ids plus a (position, hash) patch list for out-of-table
tokens.  Reconstruction on the device is one gather + one scatter
(``search/engine.py`` ``decode_stream``) and is bit-exact, so every
downstream contract (oracle parity, recall accounting) is untouched.

The table is APPEND-ONLY: an entry's id is its admission slot and
never changes, so a payload encoded against table version V decodes
correctly against any version >= V (later versions only append).  This
is what lets the engine admit a batch's misses immediately (for future
batches) while the current batch is still in flight.  A sorted shadow
array + argsort permutation makes host-side lookup a vectorized
``searchsorted`` without perturbing ids.

The table is seeded by FREQUENCY from the first batch (np.unique
counts; natural text is stationary enough that batch-1 frequencies
approximate the corpus), then grows first-come from subsequent batches'
misses until capacity.  Id 0xFFFF is reserved as the miss sentinel;
hash 0 is seeded at construction because stream buffers zero-pad their
tail and a patch per pad slot would defeat the encoding.

The native scan is ``fs_encode_stream`` of this package's own
``native/fastingest.cpp``; without that library the NumPy
``searchsorted`` path gives the same encoding.
"""

from __future__ import annotations

import ctypes

import numpy as np

SENTINEL = 0xFFFF       # u16 id meaning "not in table; see patch list"
CAPACITY = 0xFFFF       # usable ids 0..65534
PROBE_SIZE = 1 << 17    # open-addressing slots; load factor <= 0.5
PROBE_MASK = PROBE_SIZE - 1
_EMPTY = np.uint32(0xFFFFFFFF)   # probe-value marker (ids are <= 65534)


class StreamVocab:
    """Append-only vocab table; an entry's id is its admission slot."""

    def __init__(self) -> None:
        self._hashes = np.zeros(1, np.uint32)   # seed hash 0 (pad tail)
        self._sorted = self._hashes.copy()
        self._order = np.zeros(1, np.int64)     # sorted pos -> slot id
        # Linear-probing lookup table mirroring (_hashes -> slot id):
        # hashes are fmix32-finalized (uniform), so `hash & PROBE_MASK`
        # probes directly — this is what fs_encode_stream scans, and
        # np.searchsorted is only the no-native fallback (the sorted
        # path runs ~10 M tok/s; the C probe ~10^9).
        self._pk = np.zeros(PROBE_SIZE, np.uint32)
        self._pv = np.full(PROBE_SIZE, _EMPTY, np.uint32)
        self._probe_insert(self._hashes, np.array([0], np.int64))
        self.version = 0
        self.ready = False      # becomes True after bootstrap()

    def _probe_insert(self, keys: np.ndarray, slots: np.ndarray) -> None:
        pk, pv = self._pk, self._pv
        for key, slot in zip(keys.tolist(), slots.tolist()):
            p = key & PROBE_MASK
            while pv[p] != _EMPTY:
                p = (p + 1) & PROBE_MASK
            pk[p] = key
            pv[p] = slot

    @property
    def size(self) -> int:
        return int(self._hashes.size)

    def table(self) -> np.ndarray:
        """u32 [65536] device gather table (slot order).

        The sentinel slot holds 0 but is never trusted: miss positions
        are patch-scattered with their true hashes after the gather.
        """
        t = np.zeros(SENTINEL + 1, np.uint32)
        t[: self._hashes.size] = self._hashes
        return t

    def encode(self, stream: np.ndarray, miss_cap: int | None = None):
        """Encode a u32 hash stream.

        Returns (ids u16 [T] with SENTINEL at misses, miss positions
        i64 ascending, miss hashes u32, TOTAL miss count).  When
        ``miss_cap`` is given, the position/hash arrays hold at most
        the first ``miss_cap`` misses, but the returned total is
        always exact — the caller compares it against its patch
        budget and falls back to a raw upload on overflow.
        """
        from fandom_search_tpu_torch.data.fast_tokenizer import get_lib

        lib = get_lib()
        cap = stream.size if miss_cap is None else min(miss_cap, stream.size)
        if lib is not None and stream.size:
            stream = np.ascontiguousarray(stream, np.uint32)
            ids = np.empty(stream.size, np.uint16)
            mpos = np.empty(cap, np.int64)
            mhash = np.empty(cap, np.uint32)
            total = lib.fs_encode_stream(
                stream.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                stream.size,
                self._pk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                self._pv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                PROBE_MASK,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                mpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                mhash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                cap,
            )
            k = min(total, cap)
            return ids, mpos[:k], mhash[:k], total
        s = self._sorted
        idx = np.searchsorted(s, stream).astype(np.int64)
        np.minimum(idx, s.size - 1, out=idx)
        hit = s[idx] == stream
        ids = np.where(hit, self._order[idx], SENTINEL).astype(np.uint16)
        miss = np.nonzero(~hit)[0]
        return ids, miss[:cap], stream[miss[:cap]], int(miss.size)

    def bootstrap(self, stream: np.ndarray) -> None:
        """Frequency-seed the table from the first batch's stream."""
        if stream.size:
            u, c = np.unique(stream, return_counts=True)
            self._admit(u, priority=c)
        self.ready = True

    def admit(self, hashes: np.ndarray) -> None:
        """First-come trickle admission of a batch's miss hashes."""
        if hashes.size:
            self._admit(np.unique(hashes))

    def admit_counted(self, stream: np.ndarray) -> None:
        """Frequency-aware admission for heavy-miss (raw-fallback)
        batches: remaining room goes to the most frequent unseen
        words, not whichever hashes sort first."""
        if stream.size:
            u, c = np.unique(stream, return_counts=True)
            self._admit(u, priority=c)

    def _admit(self, uniq: np.ndarray, priority: np.ndarray | None = None):
        room = CAPACITY - self._hashes.size
        if room <= 0 or uniq.size == 0:
            return
        mask = ~np.isin(uniq, self._hashes, assume_unique=True)
        new = uniq[mask]
        if new.size > room:
            if priority is not None:
                top = np.argpartition(-priority[mask], room - 1)[:room]
                new = new[top]
            else:
                new = new[:room]
        if new.size == 0:
            return
        # APPEND (ids of existing entries must not move), then extend
        # the probe table and rebuild the sorted lookup shadow.
        base = self._hashes.size
        self._hashes = np.concatenate([self._hashes, new.astype(np.uint32)])
        self._probe_insert(
            new.astype(np.uint32),
            np.arange(base, base + new.size, dtype=np.int64),
        )
        self._order = np.argsort(self._hashes, kind="stable")
        self._sorted = self._hashes[self._order]
        self.version += 1
