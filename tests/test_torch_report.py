"""The port's report, matrix and heatmap copies against the JAX package's.

Tolerance: 0.  Every output is text, bytes or a record of integers and
strings computed by the same code, so files compare byte for byte and
records with ==.
"""

import numpy as np
import pytest

from fandom_search_tpu.data.script_parser import ScriptLine as JLine
from fandom_search_tpu.search import heatmap as jheatmap
from fandom_search_tpu.search import report as jreport
from fandom_search_tpu.search.types import MatchRow as JRow
from fandom_search_tpu_torch.data.script_parser import ScriptLine
from fandom_search_tpu_torch.search import heatmap, report
from fandom_search_tpu_torch.search.types import MatchRow


def _rows(cls, rng, n, scripts=("",)):
    out = []
    for i in range(n):
        start = int(rng.integers(0, 500))
        out.append(cls(
            work_id=f"w{int(rng.integers(0, 5))}", fan_token_start=start,
            fan_token_end=start + 6, fan_char_start=start * 5,
            fan_char_end=start * 5 + 30, fan_text=f'some "quoted", text {i}',
            line_no=int(rng.integers(0, 8)), speaker="ALICE",
            script_text="script line, with comma", score=float(rng.random() * 6),
            verify_score=float(rng.random()), num_shingles=int(rng.integers(1, 9)),
            script=scripts[i % len(scripts)],
        ))
    return out


def _lines(cls, scripts=("",)):
    return [cls(i, f"SPK{i % 3}", f"line <{i}> & text", scripts[i % len(scripts)])
            for i in range(8)]


@pytest.mark.parametrize("scripts", [("",), ("ep1", "ep2")])
def test_csv_matrix_and_heatmap_bytes_match(tmp_path, scripts):
    rng = np.random.default_rng(len(scripts))
    state = rng.bit_generator.state
    prow = _rows(MatchRow, rng, 40, scripts)
    rng.bit_generator.state = state
    jrow = _rows(JRow, rng, 40, scripts)
    report.write_matches_csv(prow, tmp_path / "p.csv")
    jreport.write_matches_csv(jrow, tmp_path / "j.csv")
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = report.read_matches_csv(tmp_path / "p.csv")
    assert back == jreport.read_matches_csv(tmp_path / "j.csv") and len(back) == 40
    for script_lines in (None, "lines"):
        pl = _lines(ScriptLine, scripts) if script_lines else None
        jl = _lines(JLine, scripts) if script_lines else None
        for src_p, src_j in ((prow, jrow), (back, back)):
            recs = report.aggregate_matrix(src_p, pl)
            assert recs == jreport.aggregate_matrix(src_j, jl)
        report.write_matrix_csv(recs, tmp_path / "px.csv")
        jreport.write_matrix_csv(recs, tmp_path / "jx.csv")
        assert (tmp_path / "px.csv").read_bytes() == (tmp_path / "jx.csv").read_bytes()
        for title in ("Fan engagement", "T & <co>"):
            assert (heatmap.render_engagement_html(recs, title)
                    == jheatmap.render_engagement_html(recs, title))
        heatmap.write_engagement_html(recs, tmp_path / "p.html")
        jheatmap.write_engagement_html(recs, tmp_path / "j.html")
        assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_matrix_single_script_lines_keep_row_labels():
    """`matrix --script one.txt` over multi-script rows keeps the rows'
    script labels, as the JAX package does."""
    rng = np.random.default_rng(3)
    state = rng.bit_generator.state
    prow = _rows(MatchRow, rng, 20, ("ep1", "ep2"))
    rng.bit_generator.state = state
    jrow = _rows(JRow, rng, 20, ("ep1", "ep2"))
    recs = report.aggregate_matrix(prow, _lines(ScriptLine))
    assert recs == jreport.aggregate_matrix(jrow, _lines(JLine))
    assert {r["script"] for r in recs if r["matches"]} <= {"ep1", "ep2"}


def test_empty_matrix_and_heatmap(tmp_path):
    report.write_matrix_csv([], tmp_path / "p.csv")
    jreport.write_matrix_csv([], tmp_path / "j.csv")
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert heatmap.render_engagement_html([]) == jheatmap.render_engagement_html([])
    assert report.aggregate_matrix([]) == []


def test_heatmap_escapes_and_groups():
    recs = [
        {"line_no": 0, "matches": 4, "distinct_works": 2,
         "speaker": "A", "text": "plain line", "script": "ep1"},
        {"line_no": 1, "matches": 0, "distinct_works": 0,
         "speaker": "B", "text": "<script>alert(1)</script>", "script": "ep2"},
    ]
    page = heatmap.render_engagement_html(recs, title="T & co")
    assert page == jheatmap.render_engagement_html(recs, title="T & co")
    assert "<script>alert" not in page and "T &amp; co" in page
    assert page.count('class="sect"') == 2 and 'style="width:100.00%"' in page


def test_parquet_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(9)
    state = rng.bit_generator.state
    prow = _rows(MatchRow, rng, 12)
    rng.bit_generator.state = state
    jrow = _rows(JRow, rng, 12)
    report.write_matches_parquet(prow, tmp_path / "p.parquet")
    jreport.write_matches_parquet(jrow, tmp_path / "j.parquet")
    got, want = pd.read_parquet(tmp_path / "p.parquet"), pd.read_parquet(tmp_path / "j.parquet")
    pd.testing.assert_frame_equal(got, want)
    assert got["work_id"].tolist() == [r.work_id for r in prow]
