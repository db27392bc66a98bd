"""Seeded synthetic worlds: a tagged screenplay and a pool of fan works.

A frozen copy of the port's generator (``make_vocab``, ``make_script``,
``make_corpus_with_quotes`` of ``utils/synthetic.py`` and the bench's
``flagship_world``), changed where a benchmark needs it:

* Zipf ranks come from an inverse CDF over ``Generator.random``, so one
  seed gives one world on every numpy (numpy 2.0.2 and 2.3.5 draw
  different ``zipf`` samples).  The distribution is the one the port's
  generator draws, ``(zipf(a) - 1) % size``: the tail beyond ``size``
  folds back onto the ranks.
* Work lengths are one fixed set for every seed and every call: the
  quantiles of a clipped lognormal.  The seed only orders them, so every
  call carries the same number of words.
* A traffic mix sets the quotes: a few whole script lines a work, each
  with edited words (``corpus``).

Every draw goes through ``Generator.random`` or ``Generator.integers``,
whose streams numpy keeps stable across versions.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"
# ranks summed exactly before the Euler-Maclaurin tail of the folded sum
_FOLD_TERMS = 4
# numpy's zipf rejects draws above the largest int64
_ZIPF_MAX = (1 << 63) - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a stream label."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def make_vocab(rng: np.random.Generator, size: int) -> List[str]:
    """Pronounceable pseudo-words, sorted (the port's ``make_vocab``)."""
    words = set()
    while len(words) < size:
        syls = rng.integers(2, 5)
        words.add("".join(
            _CONSONANTS[rng.integers(len(_CONSONANTS))] + _VOWELS[rng.integers(len(_VOWELS))]
            for _ in range(syls)))
    return sorted(words)


def folded_zipf_cdf(a: float, size: int) -> np.ndarray:
    """CDF over ranks [0, size) of ``(zipf(a) - 1) % size`` as numpy draws
    it: numpy rejects draws above 2^63 - 1, which at a = 1.01 conditions
    away about 64% of the law's mass.

    P(r) is proportional to the sum over j of (r + 1 + j * size)^-a up to
    2^63 - 1: the first ``_FOLD_TERMS`` terms exactly, the rest by
    Euler-Maclaurin (the integral, half the first left-out term, its
    derivative over 12; the terms at the far end are below 1e-19).
    Powers come from ``math.pow`` on each rank, not from numpy's
    vectorised ones, so the table is the same on every numpy."""
    if not a > 1.0:
        raise ValueError(f"zipf exponent must exceed 1, got {a}")
    top = math.pow(float(_ZIPF_MAX), 1.0 - a)
    pmf = np.empty(size, dtype=np.float64)
    for r in range(size):
        base = r + 1.0
        head = sum(math.pow(base + j * size, -a) for j in range(_FOLD_TERMS))
        x = base + _FOLD_TERMS * size
        fx = math.pow(x, -a)
        tail = (x * fx - top) / (size * (a - 1.0)) + fx / 2.0 + a * size * fx / x / 12.0
        pmf[r] = head + tail
    cdf = np.cumsum(pmf)
    return cdf / cdf[-1]


class Ranks:
    """Draws word indices: uniform, or by a CDF through a guide table
    (the first rank above each of 2^20 even steps), which gives exactly
    ``searchsorted(cdf, u, side="right")`` at a fraction of its cost."""

    GUIDE = 1 << 20

    def __init__(self, size: int, cdf: np.ndarray | None):
        self.size, self.cdf = size, cdf
        if cdf is not None:
            steps = np.arange(self.GUIDE + 1, dtype=np.float64) / self.GUIDE
            self.guide = np.minimum(np.searchsorted(cdf, steps, side="right"), size - 1)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.cdf is None:
            return rng.integers(0, self.size, size=n)
        u = rng.random(n)
        idx = self.guide[(u * self.GUIDE).astype(np.int64)]
        while True:
            low = (self.cdf[idx] <= u) & (idx < self.size - 1)
            if not low.any():
                return idx
            idx = idx + low


def shuffled(rng: np.random.Generator, n: int) -> np.ndarray:
    """A permutation of range(n) from ``Generator.random`` alone."""
    return np.argsort(rng.random(n), kind="stable")


@dataclass
class Script:
    """A tagged script: its text, and its lines' word ids end to end."""

    text: str
    ids: np.ndarray            # int64 [words]
    line_start: np.ndarray     # int64 [lines + 1]

    @property
    def num_lines(self) -> int:
        return len(self.line_start) - 1


def make_script(rng, vocab: Sequence[str], *, num_lines: int, words_per_line: Tuple[int, int],
                ranks: Ranks, speakers: Sequence[str]) -> Script:
    """``SPEAKER: dialogue`` lines (the port's ``make_script``)."""
    varr = np.asarray(vocab, dtype=object)
    counts = rng.integers(words_per_line[0], words_per_line[1], size=num_lines)
    ids = ranks.draw(rng, int(counts.sum()))
    sps = rng.integers(0, len(speakers), size=num_lines)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    words = varr[ids]
    text = "\n".join(f"{speakers[sps[i]]}: {' '.join(words[bounds[i]:bounds[i + 1]].tolist())}"
                     for i in range(num_lines))
    return Script(text=text, ids=ids, line_start=bounds)


def work_lengths(count: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The fixed set of ``count`` work lengths: quantiles (i + 0.5) /
    count of a lognormal with this median and sigma, clipped to [lo, hi]."""
    nd = statistics.NormalDist()
    return np.array([min(hi, max(lo, round(median * math.exp(sigma * nd.inv_cdf((i + 0.5) / count)))))
                     for i in range(count)], dtype=np.int64)


@dataclass
class Call:
    """One call's works, in the order the call hands them over."""

    texts: List[str]
    words: np.ndarray        # int64 [works] words of each work

    @property
    def total_words(self) -> int:
        return int(self.words.sum())


def _quotes(rng, script: Script, quotes: dict, vocab_size: int):
    """The script lines one work quotes, in the order they appear, end
    to end: (word ids, each line's length).

    ``{"per_work": q, "edits": e}``: q random whole lines, each with e
    of its words (e <= its length, drawn with repeats) replaced by
    uniform words."""
    nl, ls = script.num_lines, script.line_start
    lines = rng.integers(0, nl, size=int(quotes["per_work"]))
    lens = ls[lines + 1] - ls[lines]
    ids = script.ids[np.repeat(ls[lines] - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
                     + np.arange(int(lens.sum()))]
    edits = int(quotes.get("edits", 0))
    if edits and len(lines):
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        at = np.repeat(starts, edits) + rng.integers(0, np.repeat(lens, edits))
        ids[at] = rng.integers(0, vocab_size, size=len(at))
    return ids, lens


def make_call(rng, script: Script, vocab: Sequence[str], lengths: np.ndarray, quotes: dict,
              ranks: Ranks) -> Call:
    """One call: the fixed lengths in a seeded order, each work a Zipf
    body with its quoted lines spliced in at sorted random offsets."""
    varr = np.asarray(vocab, dtype=object)
    order = lengths[shuffled(rng, len(lengths))]
    texts, words = [], np.zeros(len(order), dtype=np.int64)
    for w, total in enumerate(order.tolist()):
        q_ids, q_lens = _quotes(rng, script, quotes, len(vocab))
        body_len = max(0, total - len(q_ids))
        body = ranks.draw(rng, body_len)
        at = np.sort(rng.integers(0, body_len + 1, size=len(q_lens)))
        cum = np.concatenate([[0], np.cumsum(q_lens)])
        ids = np.empty(body_len + len(q_ids), dtype=np.int64)
        b = np.arange(body_len)
        ids[b + cum[np.searchsorted(at, b, side="right")]] = body
        ids[np.repeat(at, q_lens) + np.arange(len(q_ids))] = q_ids
        texts.append(" ".join(varr[ids].tolist()))
        words[w] = len(ids)
    return Call(texts=texts, words=words)


def script_lines_for(shingles: int, words_per_line: Tuple[int, int]) -> int:
    """Lines for about ``shingles`` script shingles (one a word)."""
    mean = (words_per_line[0] + words_per_line[1] - 1) / 2.0
    return max(1, math.ceil(shingles / mean))


def make_script_world(seed: int, script_cfg: dict) -> Tuple[List[str], Script, Ranks]:
    """The vocabulary, the script and the word draw of a configuration."""
    rng = rng_for(seed, 0)
    vocab = make_vocab(rng, int(script_cfg["vocab"]))
    za = script_cfg.get("zipf_a")
    ranks = Ranks(len(vocab), folded_zipf_cdf(float(za), len(vocab)) if za else None)
    wpl = tuple(script_cfg["words_per_line"])
    script = make_script(rng, vocab, num_lines=script_lines_for(int(script_cfg["shingles"]), wpl),
                         words_per_line=wpl, ranks=ranks, speakers=script_cfg["speakers"])
    return vocab, script, ranks


def make_pool(seed: int, vocab, script: Script, ranks: Ranks, traffic: dict) -> List[Call]:
    """``traffic["pool_calls"]`` calls of ``traffic["works_per_call"]`` works."""
    ln = traffic["lengths"]
    lengths = work_lengths(int(traffic["works_per_call"]), float(ln["median"]), float(ln["sigma"]),
                           int(ln["min"]), int(ln["max"]))
    return [make_call(rng_for(seed, 1, c), script, vocab, lengths, traffic["quotes"], ranks)
            for c in range(int(traffic["pool_calls"]))]


def call_works(pool: List[Call], call_no: int) -> Dict[str, str]:
    """The works of timed call ``call_no``: pool entry call_no % len(pool)
    under ids of this call (the port keeps nothing across calls)."""
    call = pool[call_no % len(pool)]
    return {work_id(call_no, j): t for j, t in enumerate(call.texts)}


def work_id(call_no: int, j: int) -> str:
    return f"c{call_no:06d}w{j:05d}"
