"""Match CSV writer; counterpart of fandom_search_tpu/search/report.py:21."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Sequence

from fandom_search_tpu_torch.search.types import MatchRow


def write_matches_csv(rows: Sequence[MatchRow], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(MatchRow.CSV_FIELDS)
        for r in rows:
            w.writerow(r.to_csv_row())
