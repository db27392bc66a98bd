"""The comparison that decides ``correct`` has to fail: the control (the
reference in bfloat16 in the program's place) and a run whose timed path
is broken underneath, once for each fault the cells can have, on one card
and on a 2 x 2 mesh (the mesh's exchange left out:
``test_harness_mesh.py``)."""

import pytest

from benchmark.harness import runner, world
from benchmark.reference import exact_search
from conftest import TINY_CELL, add_tiny_cell


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.fixture(params=[None, (2, 2)], ids=["one_card", "mesh"])
def fault_bench(tmp_path, request):
    return add_tiny_cell(tmp_path, mesh=request.param)


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 4_000_000_001])
def test_control_is_not_correct(tiny_bench, seed):
    """At the tiny cell's size: the bf16 reference's rows in the
    program's place, through the harness's own comparison."""
    r = runner.control(TINY_CELL, seed, device="cpu", bench_json=tiny_bench)
    c = _checks(r)
    assert not r["correct"] and c["rows_missing"] > 0 and c["rows_extra"] > 0


def test_control_rows_are_the_reference_rows(tiny_bench):
    """In float32 the control's stand-in is the reference itself, and
    the comparison reads it correct: the stand-in and ``row_of`` lose
    nothing on the way."""
    from benchmark.harness import cells

    cell = cells.load_cell(TINY_CELL, tiny_bench)
    vocab, script, ranks = world.make_script_world(5, cell.config["script"])
    pool = world.make_pool(5, vocab, script, ranks, cell.traffic)
    ref = exact_search.Reference(script.text, cell.config["pipeline"])
    kept = runner._ControlRows(ref, pool, 5, 3, 4)
    checks = runner.compare(exact_search, script.text, cell.config, pool, kept, 5, 4, "cpu")
    assert runner.verdict(checks) and 3 * 4 <= len(kept) <= 3 * 5


def test_sound_run_is_correct(tiny_bench):
    r = runner.run(TINY_CELL, 11, 0.1, False, device="cpu", bench_json=tiny_bench)
    assert r["correct"] and _checks(r) == {"rows_missing": 0, "rows_extra": 0}


def test_half_the_works_left_out(fault_bench, monkeypatch):
    from fandom_search_tpu_torch.search.engine import SearchEngine

    search = SearchEngine.search_works

    def half(self, works):
        keep = dict(list(works.items())[: len(works) // 2])
        return search(self, keep)

    monkeypatch.setattr(SearchEngine, "search_works", half)
    r = runner.run(TINY_CELL, 11, 0.1, False, device="cpu", bench_json=fault_bench)
    assert not r["correct"] and _checks(r)["rows_missing"] > 0


def test_answer_altered_where_produced(fault_bench, monkeypatch):
    """The fused step's verify scores nudged on the device."""
    from fandom_search_tpu_torch.search import engine

    tail = engine.fused_tail

    def altered(*a, **kw):
        out = tail(*a, **kw).clone()
        out[3] += 1.0 / 64
        return out

    monkeypatch.setattr(engine, "fused_tail", altered)
    r = runner.run(TINY_CELL, 11, 0.1, False, device="cpu", bench_json=fault_bench)
    c = _checks(r)
    assert not r["correct"] and c["rows_missing"] > 0 and c["rows_extra"] > 0


def test_bucketed_hybrid_run_is_correct(tmp_path):
    bench_json = add_tiny_cell(tmp_path, prefilter="bucketed")
    r = runner.run(TINY_CELL, 19, 0.1, False, device="cpu", bench_json=bench_json)
    assert r["correct"]
