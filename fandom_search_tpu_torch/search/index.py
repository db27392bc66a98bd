"""Script-side index; counterpart of fandom_search_tpu/search/index.py."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from fandom_search_tpu_torch.config import SearchConfig, ShingleConfig
from fandom_search_tpu_torch.data.script_parser import ScriptLine
from fandom_search_tpu_torch.data.tokenizer import Tokenized, tokenize
from fandom_search_tpu_torch.data.shingler import embed_shingles_np, shingle_hashes


@dataclass
class ScriptIndex:
    lines: List[ScriptLine]
    tokenized: List[Tokenized]          # per line
    stream_hashes: np.ndarray           # uint32[T] all line tokens, in order
    token_line: np.ndarray              # int32[T] line_no per stream token
    shingle_line: np.ndarray            # int32[NS] attributed line per shingle
    shingle_anchor: np.ndarray          # int32[NS] shingle start offset in line
    shingle_windows: np.ndarray         # uint32[NS, n] raw shingle word hashes
    embeddings: np.ndarray              # int8[NS, dim]
    line_start: np.ndarray              # int32[L] line offset in stream_hashes
    line_lengths: np.ndarray            # int32[L] TRUE token counts (unclipped)

    @property
    def num_shingles(self) -> int:
        return int(self.embeddings.shape[0])

    def line_text(self, line_no: int) -> str:
        return self.lines[line_no].text

    def speaker(self, line_no: int) -> str:
        return self.lines[line_no].speaker

    def script_of(self, line_no: int) -> str:
        return self.lines[line_no].script


def build_script_index(
    lines: Sequence[ScriptLine],
    shingle_cfg: ShingleConfig,
    search_cfg: SearchConfig,
) -> ScriptIndex:
    tokenized = [tokenize(ln.text) for ln in lines]
    hashes = [t.hashes for t in tokenized]
    stream = (
        np.concatenate(hashes)
        if hashes
        else np.zeros((0,), dtype=np.uint32)
    )
    token_line = np.concatenate(
        [np.full(len(t), ln.line_no, dtype=np.int32) for t, ln in zip(tokenized, lines)]
    ) if tokenized else np.zeros((0,), dtype=np.int32)

    windows = shingle_hashes(stream, shingle_cfg)          # [NS, n]
    emb = embed_shingles_np(stream, shingle_cfg)           # [NS, dim]
    ns = windows.shape[0]
    mid = shingle_cfg.n // 2
    shingle_line = (
        token_line[mid : mid + ns].astype(np.int32)
        if ns
        else np.zeros((0,), dtype=np.int32)
    )

    line_lengths = np.array([len(t) for t in tokenized], dtype=np.int32)
    line_start = np.zeros((len(lines),), dtype=np.int32)
    if len(lines):
        line_start[1:] = np.cumsum(line_lengths)[:-1]

    # Shingle start offset within its attributed line (cross-line
    # shingles can start in the previous line; clamp into the line so
    # the verify segment stays line-local).
    if ns:
        ll = line_lengths[shingle_line]
        shingle_anchor = np.clip(
            np.arange(ns, dtype=np.int32) - line_start[shingle_line],
            0,
            np.maximum(0, ll - 1),
        ).astype(np.int32)
    else:
        shingle_anchor = np.zeros((0,), dtype=np.int32)

    return ScriptIndex(
        lines=list(lines),
        tokenized=tokenized,
        stream_hashes=stream,
        token_line=token_line,
        shingle_line=shingle_line,
        shingle_anchor=shingle_anchor,
        shingle_windows=windows,
        embeddings=emb,
        line_start=line_start,
        line_lengths=line_lengths,
    )


def index_from_numpy(other) -> ScriptIndex:
    """This package's ScriptIndex from any object with ScriptIndex's fields.

    Carries an index built by the JAX package (fandom_search_tpu
    .search.index) across without importing it: only its NumPy arrays
    and its ``lines`` are read.  Line tokens are re-derived with this
    package's tokenizer, which is byte-identical.
    """
    lines = [
        ScriptLine(int(ln.line_no), ln.speaker, ln.text, ln.script)
        for ln in other.lines
    ]

    def arr(name, dtype):
        return np.ascontiguousarray(np.asarray(getattr(other, name), dtype))

    return ScriptIndex(
        lines=lines,
        tokenized=[tokenize(ln.text) for ln in lines],
        stream_hashes=arr("stream_hashes", np.uint32),
        token_line=arr("token_line", np.int32),
        shingle_line=arr("shingle_line", np.int32),
        shingle_anchor=arr("shingle_anchor", np.int32),
        shingle_windows=arr("shingle_windows", np.uint32),
        embeddings=arr("embeddings", np.int8),
        line_start=arr("line_start", np.int32),
        line_lengths=arr("line_lengths", np.int32),
    )


def concat_indexes(
    parts: Sequence[Tuple[str, "ScriptIndex"]],
) -> ScriptIndex:
    """One multi-script index from per-script indexes (one corpus pass
    for a whole franchise — and on upload-bound links, ONE corpus
    upload amortized over every script).

    Each part keeps its own shingle set — built on its own token
    stream, so no cross-script shingles exist — and the arrays
    concatenate with offset fixups: line numbers shift by the running
    line count, ``line_start`` by the running token count.
    ``shingle_anchor`` is offset-invariant (both its terms shift
    equally), and no consumer uses a script-shingle index as a stream
    offset (verification gathers via line_start + anchor), so every
    downstream contract — engine, oracle, sharded, persistence —
    holds on the concatenated arrays unchanged.  Match rows report
    the owning script via ``ScriptLine.script`` / ``MatchRow.script``.
    """
    import dataclasses as _dc

    if not parts:
        raise ValueError("concat_indexes needs at least one script")
    names = [n for n, _ in parts]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate script names: {names}")
    lines: List[ScriptLine] = []
    line_off = 0
    for name, idx in parts:
        for ln in idx.lines:
            lines.append(_dc.replace(
                ln, line_no=line_off + ln.line_no, script=name
            ))
        line_off += len(idx.lines)

    def cat(field, off_field=None):
        arrs = []
        off = 0
        for _, idx in parts:
            a = getattr(idx, field)
            arrs.append(a + off if off_field else a)
            if off_field == "lines":
                off += len(idx.lines)
            elif off_field == "tokens":
                off += len(idx.stream_hashes)
        return (
            np.concatenate(arrs) if arrs[0].ndim == 1
            else np.concatenate(arrs, axis=0)
        )

    return ScriptIndex(
        lines=lines,
        tokenized=[t for _, idx in parts for t in idx.tokenized],
        stream_hashes=cat("stream_hashes"),
        token_line=cat("token_line", "lines").astype(np.int32),
        shingle_line=cat("shingle_line", "lines").astype(np.int32),
        shingle_anchor=cat("shingle_anchor"),
        shingle_windows=cat("shingle_windows"),
        embeddings=cat("embeddings"),
        line_start=cat("line_start", "tokens").astype(np.int32),
        line_lengths=cat("line_lengths"),
    )
