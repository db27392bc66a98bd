"""Result types; counterpart of fandom_search_tpu/search/types.py."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class CandidateHit:
    """One verified (fan shingle, script line) hit, pre-chaining."""

    work_id: str
    fan_pos: int          # token index of the shingle start in the fanwork
    line_no: int          # script line record index
    score: float          # estimated matching words (candidate stage)
    verify_score: float   # normalized local-alignment similarity


class MatchRow(NamedTuple):
    """One chained match span — a row of the output CSV.

    Field set mirrors the original fandom-search reporter: fanwork id,
    fan span, script line no, speaker, matched text(s), distance/ratio
    scores.  A NamedTuple, not a dataclass:
    construction is C-level, which matters when a large corpus emits
    hundreds of thousands of rows (a frozen dataclass pays
    object.__setattr__ twelve times per row).
    """

    work_id: str
    fan_token_start: int
    fan_token_end: int    # exclusive
    fan_char_start: int
    fan_char_end: int
    fan_text: str
    line_no: int
    speaker: str
    script_text: str
    score: float          # best candidate score within the span
    verify_score: float   # best verification score within the span
    num_shingles: int     # shingle hits merged into this span
    # Which source script the matched line belongs to — "" for a
    # single-script run (reference-identical), the script's name in a
    # multi-script index (search/index.py concat_indexes).  Trailing
    # column so single-script CSVs differ only by one empty field.
    script: str = ""

    CSV_FIELDS = (
        "work_id",
        "fan_token_start",
        "fan_token_end",
        "fan_char_start",
        "fan_char_end",
        "fan_text",
        "line_no",
        "speaker",
        "script_text",
        "score",
        "verify_score",
        "num_shingles",
        "script",
    )

    def to_csv_row(self):
        return [getattr(self, f) for f in self.CSV_FIELDS]
