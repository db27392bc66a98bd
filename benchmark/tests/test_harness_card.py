"""On the card: the tiny cell end to end, traced, with its rooflines
read from the device trace, the tiny cell through the LSH prefilter, and
the tiny mesh cell on four cards.  Skips without the cards."""

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness import trace as tr
from conftest import TINY_CELL, add_tiny_cell


@pytest.mark.card
def test_tiny_cell_traced_on_the_card(tiny_bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = runner.run(TINY_CELL, 2**31 + 5, 1.0, True, device="cuda", bench_json=tiny_bench)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["k2_roofline.sweep"] <= 105 and 0 < m["k4_roofline.sweep"] <= 105
    assert 0 <= m["device.idle_share.sweep"] < 100
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.card
def test_tiny_lsh_cell_traced_on_the_card(tmp_path, monkeypatch):
    """The LSH prefilter's K6 calls found in the trace, each with work to
    bound (a rerun after a budget overflow has none) within its roofline
    at the 1-bit rate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    summaries, reduce = [], tr.reduce_trace

    def keep(*a, **kw):
        summaries.append(reduce(*a, **kw))
        return summaries[-1]

    monkeypatch.setattr(tr, "reduce_trace", keep)
    bench_json = add_tiny_cell(tmp_path, prefilter="lsh")
    r = runner.run(TINY_CELL, 2**31 + 7, 1.0, True, device="cuda", bench_json=bench_json)
    assert r["correct"], r["checks"]
    (summary,) = summaries
    shares = [100 * b / t for b, t in summary.k6 if b]
    assert shares and all(0 < s <= 100 for s in shares), summary.k6
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert "k2_roofline.sweep" not in m and 0 < m["k4_roofline.sweep"] <= 105
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.card
def test_tiny_mesh_cell_traced_on_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    bench_json = add_tiny_cell(tmp_path, mesh=(2, 2))
    r = runner.run(TINY_CELL, 2**31 + 9, 1.0, True, device="cuda", bench_json=bench_json)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["k2_roofline.sweep"] <= 105
    assert m["mesh_straggler.sweep"] >= 0 and m["mesh_merge_share.sweep"] > 0
    assert r["device"]["count"] == 4 and r["device"]["busy_s"] > 0
