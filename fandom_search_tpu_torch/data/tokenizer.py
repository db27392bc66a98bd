"""Deterministic word tokenizer; counterpart of fandom_search_tpu/data/tokenizer.py."""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from fandom_search_tpu_torch.data.hashing import hash_words

# A token: letters/digits, with apostrophes allowed inside (don't, o'clock).
_TOKEN_RE = re.compile(r"[0-9a-z]+(?:'[0-9a-z]+)*")


def _lower_keep_length(text: str) -> str:
    low = text.lower()
    if len(low) != len(text):
        # Rare unicode chars lowercase to multiple chars (e.g. 'İ'),
        # which would desync offsets; lower per-char, keeping length.
        low = "".join(c.lower() if len(c.lower()) == 1 else c for c in text)
    return low


class Tokenized:
    """Tokens of one text plus everything needed to map back to it.

    ``tokens`` (the lowercased word strings) is LAZY: search only needs
    ``hashes`` and ``offsets``, and materializing hundreds of thousands
    of Python string slices per corpus batch was measurable host time.
    The property rebuilds them from offsets on first touch.
    """

    __slots__ = ("text", "offsets", "hashes", "_tokens")

    def __init__(
        self,
        text: str,
        tokens: List[str] | None = None,
        offsets: np.ndarray | None = None,
        hashes: np.ndarray | None = None,
    ) -> None:
        self.text = text
        self._tokens = tokens
        self.offsets = (
            offsets if offsets is not None else np.zeros((0, 2), np.int32)
        )
        # uint32[num_tokens] word hashes (fmix32(FNV-1a(token))).
        self.hashes = hashes if hashes is not None else hash_words(self.tokens)

    @property
    def tokens(self) -> List[str]:
        if self._tokens is None:
            low = _lower_keep_length(self.text)
            self._tokens = [low[a:b] for a, b in self.offsets.tolist()]
        return self._tokens

    def __len__(self) -> int:
        return int(self.offsets.shape[0])

    def span_text(self, tok_start: int, tok_end: int) -> str:
        """Original text covered by tokens [tok_start, tok_end)."""
        if tok_end <= tok_start or len(self) == 0:
            return ""
        a = int(self.offsets[tok_start, 0])
        b = int(self.offsets[tok_end - 1, 1])
        return self.text[a:b]


def tokenize(text: str) -> Tokenized:
    """Lowercase + word-split with original-string offsets."""
    low = _lower_keep_length(text)
    tokens: List[str] = []
    spans: List[Tuple[int, int]] = []
    for m in _TOKEN_RE.finditer(low):
        tokens.append(m.group(0))
        spans.append((m.start(), m.end()))
    # int32 offsets: texts are far below 2 GB, and the corpus-wide
    # Tokenized cache (chaining needs every work) is offset-dominated —
    # int64 doubled resident memory at 100k-work scale for nothing
    offsets = (
        np.array(spans, dtype=np.int32)
        if spans
        else np.zeros((0, 2), dtype=np.int32)
    )
    return Tokenized(text=text, tokens=tokens, offsets=offsets)
