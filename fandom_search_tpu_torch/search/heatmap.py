"""Self-contained HTML engagement view (the Fan Engagement Meter); counterpart of fandom_search_tpu/search/heatmap.py.

``render_engagement_html`` turns ``aggregate_matrix`` records into one
dependency-free HTML file: a table of script lines with an inline
magnitude bar per line, a KPI row, hover detail, and light/dark
styling.  No external assets, no network.  The page is byte-identical
to the JAX package's for the same records.

Form notes: the job is *magnitude per line*, so this is a single-series
bar-in-table (sequential single hue), not a categorical chart; identity
of multi-script indexes comes from section grouping, never color.
"""

from __future__ import annotations

import html
import json
from pathlib import Path
from typing import Dict, List, Sequence

# One hue carries magnitude (single series). Values from the validated
# default palette (slot-1 blue, stepped per mode); text/chrome are the
# matching ink tokens.
_CSS = """
:root { color-scheme: light dark; }
.viz-root {
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --ink-1: #0b0b0b; --ink-2: #52514e; --ink-3: #898781;
  --hairline: #e1e0d9; --series-1: #2a78d6;
  --wash: rgba(42, 120, 214, 0.08);
  color-scheme: light;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    --surface-1: #1a1a19; --page: #0d0d0d;
    --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
    --hairline: #2c2c2a; --series-1: #3987e5;
    --wash: rgba(57, 135, 229, 0.14);
    color-scheme: dark;
  }
}
:root[data-theme="dark"] .viz-root {
  --surface-1: #1a1a19; --page: #0d0d0d;
  --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-3: #898781;
  --hairline: #2c2c2a; --series-1: #3987e5;
  --wash: rgba(57, 135, 229, 0.14);
  color-scheme: dark;
}
.viz-root {
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--ink-1);
  margin: 0; padding: 24px; min-height: 100vh; box-sizing: border-box;
}
.viz-root h1 { font-size: 18px; font-weight: 600; margin: 0 0 2px; }
.viz-root .sub { color: var(--ink-2); margin: 0 0 16px; }
.kpis { display: flex; gap: 12px; flex-wrap: wrap; margin: 0 0 16px; }
.tile {
  background: var(--surface-1); border: 1px solid var(--hairline);
  border-radius: 8px; padding: 10px 14px; min-width: 130px;
}
.tile .lbl { color: var(--ink-2); font-size: 12px; }
.tile .val { font-size: 24px; font-weight: 600; }
.card {
  background: var(--surface-1); border: 1px solid var(--hairline);
  border-radius: 8px; padding: 4px 0; overflow: hidden;
}
.sect {
  color: var(--ink-2); font-weight: 600; font-size: 13px;
  padding: 10px 14px 4px; border-top: 1px solid var(--hairline);
}
.card .sect:first-child { border-top: none; }
table.lines { border-collapse: collapse; width: 100%; }
.lines td {
  padding: 3px 8px; vertical-align: baseline;
  border: none; font-variant-numeric: tabular-nums;
}
.lines tr:hover { background: var(--wash); }
.lines .no { color: var(--ink-3); text-align: right; width: 3.5em; }
.lines .spk { color: var(--ink-2); white-space: nowrap; }
.lines .txt { color: var(--ink-1); width: 45%; }
.lines .n { text-align: right; width: 3em; color: var(--ink-1); }
.lines .barcell { width: 30%; padding-right: 14px; }
.bar {
  height: 12px; background: var(--series-1);
  border-radius: 0 4px 4px 0; min-width: 0;
}
.bar.zero { background: transparent; }
#tip {
  position: fixed; pointer-events: none; display: none; z-index: 10;
  background: var(--surface-1); color: var(--ink-1);
  border: 1px solid var(--hairline); border-radius: 6px;
  padding: 5px 9px; font-size: 12px;
  box-shadow: 0 2px 8px rgba(0,0,0,0.12);
}
#tip .d { color: var(--ink-2); }
.foot { color: var(--ink-3); font-size: 12px; margin-top: 12px; }
"""

_JS = """
(function () {
  var tip = document.getElementById('tip');
  document.querySelectorAll('tr[data-m]').forEach(function (tr) {
    tr.addEventListener('mousemove', function (e) {
      tip.innerHTML = '<b>' + tr.dataset.m + '</b> match' +
        (tr.dataset.m === '1' ? '' : 'es') +
        ' <span class="d">&middot; ' + tr.dataset.w + ' work' +
        (tr.dataset.w === '1' ? '' : 's') + '</span>';
      tip.style.display = 'block';
      var x = Math.min(e.clientX + 14, window.innerWidth - tip.offsetWidth - 8);
      tip.style.left = x + 'px';
      tip.style.top = (e.clientY + 14) + 'px';
    });
    tr.addEventListener('mouseleave', function () {
      tip.style.display = 'none';
    });
  });
})();
"""


def _tile(label: str, value: str) -> str:
    return (
        f'<div class="tile"><div class="lbl">{html.escape(label)}</div>'
        f'<div class="val">{html.escape(value)}</div></div>'
    )


def _row(rec: Dict, peak: int) -> str:
    m = int(rec.get("matches", 0))
    w = int(rec.get("distinct_works", 0))
    pct = 0.0 if peak <= 0 else 100.0 * m / peak
    spk = rec.get("speaker", "")
    txt = rec.get("text", "")
    bar_cls = "bar zero" if m == 0 else "bar"
    return (
        f'<tr data-m="{m}" data-w="{w}">'
        f'<td class="no">{int(rec["line_no"])}</td>'
        f'<td class="spk">{html.escape(str(spk))}</td>'
        f'<td class="txt">{html.escape(str(txt))}</td>'
        f'<td class="n">{m if m else ""}</td>'
        f'<td class="barcell"><div class="{bar_cls}" '
        f'style="width:{pct:.2f}%"></div></td></tr>'
    )


def render_engagement_html(
    records: Sequence[Dict], title: str = "Fan engagement"
) -> str:
    """One self-contained HTML page from ``aggregate_matrix`` records.

    Records may carry ``speaker``/``text`` (script provided at
    aggregation time) and ``script`` (multi-script index); rows group
    into per-script sections when several script names appear.
    """
    records = list(records)
    total = sum(int(r.get("matches", 0)) for r in records)
    quoted = sum(1 for r in records if int(r.get("matches", 0)) > 0)
    peak = max((int(r.get("matches", 0)) for r in records), default=0)

    by_script: Dict[str, List[Dict]] = {}
    for r in records:
        by_script.setdefault(str(r.get("script", "") or ""), []).append(r)
    multi = len(by_script) > 1

    kpis = [
        _tile("Total matches", f"{total:,}"),
        _tile("Lines quoted", f"{quoted:,} / {len(records):,}"),
        _tile("Peak line matches", f"{peak:,}"),
    ]
    if multi:
        kpis.append(_tile("Scripts", f"{len(by_script):,}"))

    sections = []
    for name, recs in by_script.items():
        if multi:
            sections.append(f'<div class="sect">{html.escape(name or "(unnamed script)")}</div>')
        body = "".join(_row(r, peak) for r in recs)
        sections.append(f'<table class="lines"><tbody>{body}</tbody></table>')

    t = html.escape(title)
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{t}</title><style>{_CSS}</style></head>
<body class="viz-root">
<h1>{t}</h1>
<p class="sub">Matches of script lines across the fanwork corpus;
bar length is match count (peak {peak:,}). Hover a line for detail.</p>
<div class="kpis">{''.join(kpis)}</div>
<div class="card">{''.join(sections)}</div>
<p class="foot">Generated by fandom-search-tpu &middot; counts:
{json.dumps({'total_matches': total, 'lines': len(records), 'quoted_lines': quoted})}</p>
<div id="tip"></div>
<script>{_JS}</script>
</body></html>
"""


def write_engagement_html(
    records: Sequence[Dict], path: str | Path, title: str = "Fan engagement"
) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(render_engagement_html(records, title), encoding="utf-8")
