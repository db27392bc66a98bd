"""Synthetic corpora with planted quotes; counterpart of fandom_search_tpu/utils/synthetic.py."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def make_vocab(rng: np.random.Generator, size: int = 5000) -> List[str]:
    """Pronounceable pseudo-words; distinct with overwhelming probability."""
    words = set()
    while len(words) < size:
        syls = rng.integers(2, 5)
        w = "".join(
            _CONSONANTS[rng.integers(len(_CONSONANTS))]
            + _VOWELS[rng.integers(len(_VOWELS))]
            for _ in range(syls)
        )
        words.add(w)
    return sorted(words)


def _vocab_arr(vocab: List[str]) -> np.ndarray:
    """Cached object-array view of a vocab list."""
    arr = getattr(_vocab_arr, "_cache", (None, None))
    if arr[0] is not vocab:
        _vocab_arr._cache = (vocab, np.asarray(vocab, dtype=object))
    return _vocab_arr._cache[1]


def make_script(
    rng: np.random.Generator,
    vocab: List[str],
    num_lines: int = 40,
    words_per_line: Tuple[int, int] = (4, 14),
    speakers: Tuple[str, ...] = ("ALICE", "BOB", "CAROL"),
) -> str:
    """A 'tagged'-format script: SPEAKER: dialogue."""
    counts = rng.integers(*words_per_line, size=num_lines)
    words = _vocab_arr(vocab)[rng.integers(0, len(vocab), size=int(counts.sum()))]
    sps = np.asarray(speakers, dtype=object)[
        rng.integers(0, len(speakers), size=num_lines)
    ]
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return "\n".join(
        f"{sps[i]}: {' '.join(words[bounds[i]:bounds[i+1]].tolist())}"
        for i in range(num_lines)
    )


def mutate_words(
    rng: np.random.Generator, words: List[str], vocab: List[str], num_edits: int
) -> List[str]:
    """Apply word-level substitutions (the controlled edit distance)."""
    out = list(words)
    if not out:
        return out
    pos = rng.choice(len(out), size=min(num_edits, len(out)), replace=False)
    for p in pos:
        out[p] = vocab[rng.integers(len(vocab))]
    return out


@dataclasses.dataclass
class PlantedQuote:
    work_id: str
    line_no: int          # which script line was planted
    word_start: int       # word offset in the fanwork
    num_edits: int


def make_corpus_with_quotes(
    rng: np.random.Generator,
    script_lines: List[str],          # raw dialogue texts (no speaker tag)
    num_works: int = 10,
    words_per_work: int = 400,
    quotes_per_work: int = 2,
    num_edits: int = 0,
    vocab: List[str] | None = None,
) -> Tuple[Dict[str, str], List[PlantedQuote]]:
    """Random fanworks with script lines spliced in at known offsets."""
    vocab = vocab or make_vocab(rng)
    works: Dict[str, str] = {}
    planted: List[PlantedQuote] = []
    varr = _vocab_arr(vocab)
    for w in range(num_works):
        wid = f"work{w:05d}"
        body = varr[rng.integers(0, len(vocab), size=words_per_work)].tolist()
        # Choose all insertion points in the ORIGINAL body and insert
        # back-to-front, so one planted quote never splits another.
        ats = sorted(
            (int(rng.integers(0, len(body))) for _ in range(quotes_per_work)),
            reverse=True,
        )
        for at in ats:
            line_no = int(rng.integers(len(script_lines)))
            quote = script_lines[line_no].lower().split()
            quote = mutate_words(rng, quote, vocab, num_edits)
            body = body[:at] + quote + body[at:]
            planted.append(PlantedQuote(wid, line_no, at, num_edits))
        works[wid] = " ".join(body)
    return works, planted
