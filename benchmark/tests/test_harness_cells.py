"""BENCHMARK.json against the contract's rules, and the harness finding a
new cell, configuration and metric by name, with no file edited."""

import json
import re
from pathlib import Path

from benchmark.harness import cells, runner

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_follows_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and len(spec["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    cellnames, four = set(), 0
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        cellnames.add(w["name"])
        four += w["chips"] == 4
    assert len(cellnames) == len(spec["workloads"]) <= 24
    assert four <= max(1, len(spec["workloads"]) // 4)
    assert {c["config"] for c in spec["workloads"]} == names
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= cellnames
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        doc = cells.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py").__doc__
        assert f"layer: {m['layer']}" in doc and f"source: {m['source']}" in doc
        if m["unit"] == "%" and m["name"].endswith("_roofline.sweep"):
            assert m["better"] == "higher"
    for w in cellnames:
        c = cells.load_cell(w)
        assert {m["name"] for m in c.end_to_end} >= {"setup_s", "search_words_per_s"}
        assert c.per_layer


def test_config_files_state_their_cuts():
    for f in (ROOT / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        assert c["name"] == f.stem and "reduced" in c and "assumed" in c and "source" in c


def test_a_cell_config_and_metric_added_as_files_are_found(tmp_path):
    from conftest import TINY_CELL, add_tiny_cell

    bench_json = add_tiny_cell(tmp_path)
    (tmp_path / "benchmark" / "metrics" / "calls_in_window.sweep.py").write_text(
        '"""calls_in_window.sweep: a throwaway metric.\n\nlayer: test\n"""\n\n\n'
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    spec = json.loads(bench_json.read_text())
    spec["per_layer"].append({"name": "calls_in_window.sweep", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "search_words_per_s", "workloads": [TINY_CELL]})
    bench_json.write_text(json.dumps(spec))
    cell = cells.load_cell(TINY_CELL, bench_json)
    assert cell.config["script"]["shingles"] == 4000 and cell.traffic["works_per_call"] == 16
    result = runner.run(TINY_CELL, 77, 0.1, True, device="cpu", bench_json=bench_json)
    assert result["correct"]
    assert result["metrics"]["calls_in_window.sweep"] == {"value": 1.0, "unit": "calls"}


def test_result_line_has_the_contract_keys(tiny_bench):
    from conftest import TINY_CELL

    plain = runner.run(TINY_CELL, 2**31 + 99, 0.1, False, device="cpu", bench_json=tiny_bench)
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(plain["metrics"]) == {"search_words_per_s", "setup_s"}
    assert set(plain["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert plain["correct"] and plain["attempted"] == 16 and plain["failed"] == 0
    assert plain["checks"] == {"rows_missing": {"value": 0, "limit": 0},
                               "rows_extra": {"value": 0, "limit": 0}}
    traced = runner.run(TINY_CELL, 2**31 + 99, 0.1, True, device="cpu", bench_json=tiny_bench)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "breakdown", "device",
                            "checks"]
    assert set(traced["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                     "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: the device metrics read nothing
    assert set(traced["metrics"]) == {"batchgen_share.sweep", "pull_wait_share.sweep",
                                      "host_post_share.sweep"}
    assert json.loads(json.dumps(traced)) == traced
