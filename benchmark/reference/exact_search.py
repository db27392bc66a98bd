"""The exact answer of a search, worked out again from the texts.

A plain implementation of the search's semantics, independent of the
program: it tokenizes and hashes the script and the works itself, embeds
every shingle, scores each work shingle against every script shingle
with a float32 matrix product (exact on these integers, TF32 off), keeps
each work shingle's top k at or above the candidate threshold (ties to
the lower script shingle), keeps the best script shingle a (work
position, line), scores the verify windows by Smith-Waterman and chains
the verified hits into rows.  The steps follow the fandom-search
pipeline as the port's NumPy oracle states it; the tokenizer, the hash
and the sign embedding are frozen copies of their plain definitions.

``precision="bfloat16"`` computes the float32 steps (the candidate score
and the normalised alignment score) in bfloat16 instead: the benchmark's
control, which the comparison has to fail.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[0-9a-z]+(?:'[0-9a-z]+)*")
_TAGGED_RE = re.compile(r"^([A-Za-z0-9_ .'\-]{1,40}?)\s*[:\t]\s*(\S.*)$")
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_M32 = 0xFFFFFFFF
_GAMMA_POS = 0x9E3779B9
_GAMMA_ROUND = 0x7F4A7C15


@dataclass(frozen=True)
class Params:
    """The search's settings (the port's ShingleConfig and SearchConfig
    defaults, as a configuration file states them)."""

    n: int = 6
    dim: int = 128
    seed: int = 0x5EED
    k: int = 10
    candidate_threshold: float = 3.5
    verify_threshold: float = 0.35
    window_tokens: int = 64
    max_line_tokens: int = 64
    chain_gap: int = 12
    sw_match: float = 2.0
    sw_mismatch: float = -1.0
    sw_gap: float = -1.0

    @classmethod
    def from_config(cls, pipeline: dict) -> "Params":
        flat = {**pipeline.get("shingle", {}), **pipeline.get("search", {})}
        return cls(**{k: v for k, v in flat.items() if k in cls.__dataclass_fields__})


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _hash_word(word: str) -> int:
    h = _FNV_OFFSET
    for b in word.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _M32
    return _fmix32(h)


class _Hasher:
    """Word hashes, each word hashed once."""

    def __init__(self):
        self._seen: Dict[str, int] = {}

    def __call__(self, words: Sequence[str]) -> np.ndarray:
        seen = self._seen
        for w in set(words).difference(seen):
            seen[w] = _hash_word(w)
        return np.fromiter(map(seen.__getitem__, words), dtype=np.uint32, count=len(words))


@dataclass
class Tokens:
    hashes: np.ndarray     # uint32 [T]
    offsets: np.ndarray    # int64 [T, 2] character spans in the text


def tokenize(text: str, hasher: _Hasher) -> Tokens:
    """Lowercased words (letters, digits, inner apostrophes) and their
    character spans.  The texts here are ASCII, so lowercasing keeps
    every offset."""
    low = text.lower()
    words, spans = [], []
    for m in _TOKEN_RE.finditer(low):
        words.append(m.group(0))
        spans.append(m.span())
    offsets = np.array(spans, dtype=np.int64).reshape(-1, 2)
    return Tokens(hasher(words), offsets)


def sign_mults(p: Params) -> np.ndarray:
    """uint32 [n, dim]: fmix32(fmix32(seed + (i+1) * GAMMA_POS) ^ (l+1) * GAMMA_ROUND) | 1."""
    out = np.empty((p.n, p.dim), dtype=np.uint32)
    for i in range(p.n):
        base = _fmix32((p.seed + ((i + 1) * _GAMMA_POS & _M32)) & _M32)
        for lane in range(p.dim):
            out[i, lane] = _fmix32(base ^ ((lane + 1) * _GAMMA_ROUND & _M32)) | 1
    return out


def embed(hashes: np.ndarray, mults: np.ndarray, device, rows: int = 1 << 18) -> torch.Tensor:
    """float32 [T - n + 1, dim]: per shingle, the sum over its n words
    of +1 or -1 by the top bit of (hash * mult) mod 2^32.  The product
    is split at 16 bits so that no int64 overflows."""
    n = mults.shape[0]
    m = max(0, len(hashes) - n + 1)
    h = torch.from_numpy(hashes.astype(np.int64)).to(device)
    mu = torch.from_numpy(mults.astype(np.int64)).to(device)
    acc = torch.zeros((m, mults.shape[1]), dtype=torch.float32, device=device)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        for i in range(n):
            hi = h[r0 + i:r1 + i, None]
            low = hi * (mu[i] & 0xFFFF)[None, :]
            high = ((hi * (mu[i] >> 16)[None, :]) & 0xFFFF) << 16
            acc[r0:r1] += (1 - 2 * (((low + high) & _M32) >> 31)).float()
    return acc


@dataclass
class ScriptRef:
    stream: np.ndarray         # uint32 [T] every line's tokens in order
    line_start: np.ndarray     # int64 [L]
    line_len: np.ndarray       # int64 [L]
    shingle_line: np.ndarray   # int64 [NS] line of each shingle's middle word
    anchor: np.ndarray         # int64 [NS] shingle start within that line
    emb_t: torch.Tensor        # [dim, NS] on the device, in the compute precision


def parse_tagged(text: str) -> List[Tuple[str, str]]:
    """(speaker, dialogue) of each non-blank line of a ``SPEAKER: text``
    script; a line without a tag is unattributed."""
    out = []
    for ln in text.splitlines():
        if not ln.strip():
            continue
        m = _TAGGED_RE.match(ln)
        out.append((m.group(1).strip(), m.group(2).strip()) if m else ("", ln.strip()))
    return out


def build_script(text: str, p: Params, hasher: _Hasher, device, dtype) -> ScriptRef:
    if p.dim & (p.dim - 1):
        raise ValueError(f"dim must be a power of two, got {p.dim}")
    lines = parse_tagged(text)
    words = [_TOKEN_RE.findall(t.lower()) for _, t in lines]
    lens = np.array([len(w) for w in words], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    stream = hasher([w for ws in words for w in ws])
    token_line = np.repeat(np.arange(len(lines), dtype=np.int64), lens)
    ns = max(0, len(stream) - p.n + 1)
    mid = p.n // 2
    sline = token_line[mid:mid + ns]
    anchor = np.clip(np.arange(ns) - starts[sline], 0, np.maximum(0, lens[sline] - 1))
    emb = embed(stream, sign_mults(p), device)
    return ScriptRef(stream, starts, lens, sline, anchor, emb.to(dtype).T.contiguous())


def candidates(q: torch.Tensor, sref: ScriptRef, p: Params, dtype, rows: int = 512):
    """Per work shingle, its top k script shingles at or above the
    threshold, ties to the lower index: (query row, script index, score)
    as numpy arrays, in query order and best first.  Scores are dot / dim
    in the compute precision."""
    # dot / dim >= threshold, tested on the dot (dim is a power of two,
    # so the division is exact in either precision)
    thr_dot = p.candidate_threshold * p.dim
    out_q, out_s, out_v = [], [], []
    for r0 in range(0, q.shape[0], rows):
        dot = q[r0:r0 + rows].to(dtype) @ sref.emb_t               # [r, NS]
        qi, si = torch.nonzero(dot >= thr_dot, as_tuple=True)
        v = (dot[qi, si] / p.dim).float()
        qi, si, v = qi.cpu().numpy() + r0, si.cpu().numpy(), v.cpu().numpy()
        order = np.lexsort((si, -v, qi))
        qi, si, v = qi[order], si[order], v[order]
        first = np.searchsorted(qi, qi, side="left")
        keep = (np.arange(len(qi)) - first) < p.k
        out_q.append(qi[keep])
        out_s.append(si[keep])
        out_v.append(v[keep])
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return cat(out_q, np.int64), cat(out_s, np.int64), cat(out_v, np.float32)


def smith_waterman(a: np.ndarray, b: np.ndarray, la: np.ndarray, lb: np.ndarray,
                   p: Params) -> np.ndarray:
    """Best local alignment score of each pair (a[i, :la[i]], b[i, :lb[i]]),
    as float32, one DP row at a time over all pairs."""
    bsz, wa = a.shape
    wb = b.shape[1]
    h = np.zeros((bsz, wb + 1), dtype=np.float32)
    best = np.zeros(bsz, dtype=np.float32)
    m, mm, g = np.float32(p.sw_match), np.float32(p.sw_mismatch), np.float32(p.sw_gap)
    col_ok = np.arange(1, wb + 1)[None, :] <= lb[:, None]
    for i in range(wa):
        row_ok = (i < la)[:, None] & col_ok
        sub = np.where(a[:, i:i + 1] == b, m, mm)
        new = np.zeros_like(h)
        up = h[:, 1:] + g
        diag = h[:, :-1] + sub
        cand = np.maximum(np.maximum(diag, up), np.float32(0))
        for j in range(1, wb + 1):
            v = np.maximum(cand[:, j - 1], new[:, j - 1] + g)
            new[:, j] = np.where(row_ok[:, j - 1], v, np.float32(0))
        h = new
        best = np.maximum(best, h.max(axis=1))
    return best


def verify(w: Tokens, sref: ScriptRef, qpos: np.ndarray, sidx: np.ndarray, line: np.ndarray,
           p: Params, dtype) -> np.ndarray:
    """Normalised alignment score of each deduplicated candidate: the
    work window centred on the shingle against the line segment centred
    on the script shingle."""
    t = len(w.hashes)
    w_, mlt = p.window_tokens, p.max_line_tokens
    lead, lead_b = (w_ - p.n) // 2, (mlt - p.n) // 2
    a0 = np.minimum(np.maximum(0, qpos - lead), max(0, t - w_))
    la = np.minimum(t, a0 + w_) - a0
    llen = sref.line_len[line]
    b0 = np.minimum(np.maximum(0, sref.anchor[sidx] - lead_b), np.maximum(0, llen - mlt))
    lb = np.minimum(llen - b0, mlt)
    gs = sref.line_start[line] + b0
    a = w.hashes[np.minimum(a0[:, None] + np.arange(w_)[None, :], max(0, t - 1))]
    b = sref.stream[np.minimum(gs[:, None] + np.arange(mlt)[None, :], len(sref.stream) - 1)]
    best = smith_waterman(a.astype(np.int64), b.astype(np.int64), la, lb, p)
    den = np.float32(p.sw_match) * np.minimum(la, lb).astype(np.float32)
    v = np.where(den > 0, best / np.maximum(den, np.float32(1)), np.float32(0)).astype(np.float32)
    if dtype is not torch.float32:
        v = torch.from_numpy(v).to(dtype).float().numpy()
    return v


Row = Tuple[str, int, int, int, int, int, float, float, int]


def chain(work: str, w: Tokens, qpos, line, score, vscore, p: Params) -> List[Row]:
    """Verified hits grouped by line, ordered by position, merged while
    the gap is at most chain_gap: one row a run with its best scores."""
    rows: List[Row] = []
    t = len(w.hashes)
    order = np.lexsort((qpos, line))
    q, ln, sc, vs = qpos[order], line[order], score[order], vscore[order]
    s = 0
    while s < len(q):
        e = s + 1
        while e < len(q) and ln[e] == ln[s] and q[e] - q[e - 1] <= p.chain_gap:
            e += 1
        start, last = int(q[s]), int(q[e - 1])
        end = min(last + p.n, t)
        c0 = int(w.offsets[start, 0])
        c1 = int(w.offsets[end - 1, 1]) if end > start else c0
        rows.append((work, start, end, c0, c1, int(ln[s]), round(float(sc[s:e].max()), 4),
                     round(float(vs[s:e].max()), 4), e - s))
        s = e
    return rows


class Reference:
    """The script's side, built once; ``rows(work_id, text)`` gives a
    work's rows."""

    def __init__(self, script_text: str, pipeline: dict, device="cpu",
                 precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be float32 or bfloat16, got {precision}")
        self.p = Params.from_config(pipeline)
        self.device = torch.device(device)
        self.dtype = torch.float32 if precision == "float32" else torch.bfloat16
        self._hasher = _Hasher()
        self._mults = sign_mults(self.p)
        self.script = build_script(script_text, self.p, self._hasher, self.device, self.dtype)

    def rows(self, work: str, text: str) -> List[Row]:
        p, sref = self.p, self.script
        w = tokenize(text, self._hasher)
        if len(w.hashes) < p.n or sref.emb_t.shape[1] == 0:
            return []
        q = embed(w.hashes, self._mults, self.device)
        qi, si, v = candidates(q, sref, p, self.dtype)
        line = sref.shingle_line[si]
        # one candidate a (position, line): the best score, then the
        # lower script shingle (candidates come best first)
        order = np.lexsort((np.arange(len(qi)), line, qi))
        qi, si, v, line = qi[order], si[order], v[order], line[order]
        first = np.ones(len(qi), dtype=bool)
        first[1:] = (qi[1:] != qi[:-1]) | (line[1:] != line[:-1])
        qi, si, v, line = qi[first], si[first], v[first], line[first]
        vs = verify(w, sref, qi, si, line, p, self.dtype)
        ok = vs >= np.float32(p.verify_threshold)
        return chain(work, w, qi[ok], line[ok], v[ok], vs[ok], p)


def row_of(match) -> Row:
    """The compared fields of a program's match row (any object with the
    CSV's field names)."""
    return (match.work_id, int(match.fan_token_start), int(match.fan_token_end),
            int(match.fan_char_start), int(match.fan_char_end), int(match.line_no),
            round(float(match.score), 4), round(float(match.verify_score), 4),
            int(match.num_shingles))


def disable_tf32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
