"""Screenplay parser; counterpart of fandom_search_tpu/data/script_parser.py."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

_TAGGED_RE = re.compile(r"^([A-Za-z0-9_ .'\-]{1,40}?)\s*[:\t]\s*(\S.*)$")
_CUE_RE = re.compile(r"^\s*([A-Z][A-Z0-9 .'\-]{0,38}[A-Z0-9.])\s*(?:\(.*\))?\s*$")
_HEADING_RE = re.compile(r"^\s*(INT\.|EXT\.|FADE |CUT TO|DISSOLVE)", re.I)
_PAREN_RE = re.compile(r"^\s*\(.*\)\s*$")


@dataclass(frozen=True)
class ScriptLine:
    line_no: int      # 0-based index into the parsed record list
    speaker: str      # "" when the text is not attributed dialogue
    text: str
    script: str = ""  # source-script name in a multi-script index


def _looks_tagged(lines: List[str]) -> bool:
    nonempty = [ln for ln in lines if ln.strip()]
    if not nonempty:
        return False
    hits = sum(1 for ln in nonempty[:200] if _TAGGED_RE.match(ln))
    return hits >= 0.6 * min(len(nonempty), 200)


def parse_script(text: str) -> List[ScriptLine]:
    lines = text.splitlines()
    if _looks_tagged(lines):
        return _parse_tagged(lines)
    return _parse_screenplay(lines)


def _parse_tagged(lines: List[str]) -> List[ScriptLine]:
    out: List[ScriptLine] = []
    for ln in lines:
        if not ln.strip():
            continue
        m = _TAGGED_RE.match(ln)
        if m:
            out.append(ScriptLine(len(out), m.group(1).strip(), m.group(2).strip()))
        else:
            out.append(ScriptLine(len(out), "", ln.strip()))
    return out


def _parse_screenplay(lines: List[str]) -> List[ScriptLine]:
    out: List[ScriptLine] = []
    speaker = ""
    in_dialogue = False
    for raw in lines:
        ln = raw.strip()
        if not ln:
            speaker, in_dialogue = "", False
            continue
        if _HEADING_RE.match(ln):
            out.append(ScriptLine(len(out), "", ln))
            speaker, in_dialogue = "", False
            continue
        if _PAREN_RE.match(ln):
            continue  # parenthetical inside a speech: skip, keep speaker
        cue = _CUE_RE.match(raw)
        if cue and not in_dialogue and len(ln.split()) <= 4:
            speaker = cue.group(1).strip()
            in_dialogue = True
            continue
        if in_dialogue and speaker:
            out.append(ScriptLine(len(out), speaker, ln))
        else:
            out.append(ScriptLine(len(out), "", ln))
    return _merge_speech_lines(out)


def _merge_speech_lines(records: List[ScriptLine]) -> List[ScriptLine]:
    """Join consecutive records of the same speaker into one utterance.

    Screenplays hard-wrap dialogue; the reference attributes matches to
    whole spoken lines, so a wrapped speech becomes one record.
    Unattributed records (speaker "") are NOT merged — scene headings
    are independent lines.
    """
    out: List[ScriptLine] = []
    for rec in records:
        if out and rec.speaker and rec.speaker == out[-1].speaker:
            prev = out[-1]
            out[-1] = ScriptLine(prev.line_no, prev.speaker, prev.text + " " + rec.text)
        else:
            out.append(ScriptLine(len(out), rec.speaker, rec.text))
    return out
