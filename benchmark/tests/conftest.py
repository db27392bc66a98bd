"""Fixtures of the benchmark's own tests: a temporary copy of the
benchmark with a tiny cell added as files (a configuration, a traffic
mix and the cell's entry), small enough to run on the CPU.

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA device and skip without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELL = "tiny.tiny"
# the tiny cell's pipeline section of each prefilter: the hybrid, and the
# LSH prefilter at LSHConfig's matched-recall defaults
PREFILTER_SECTIONS = {"bucketed": {"pairs": "all"},
                      "lsh": {"bits": 1024, "rerank": 256, "seed": 0xB175}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


def add_tiny_cell(dst: Path, *, prefilter=None, mix="corpus", works=16, mesh=None) -> Path:
    """Copy BENCHMARK.json and benchmark/ to ``dst`` and add the cell
    ``tiny.tiny`` by files alone: ``configs/tiny.json`` (the series
    configuration at 4,000 shingles and a 2^14 batch), ``traffic/tiny.json``
    (``mix`` at 16 short works a call).  The cell reports the per-layer
    metrics of the real cell on its path (``series.corpus``,
    ``canon_bucketed.corpus`` with the bucketed prefilter, or
    ``canon_mesh.corpus`` with a ``mesh`` of (works, script) cards, which
    the cell asks for as its chips); with the LSH prefilter, which runs
    no K2, those of ``series.corpus`` but K2's roofline.  Returns the
    copy's BENCHMARK.json."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs" / "series.json").read_text())
    cfg["script"].update(shingles=4000, vocab=3000)
    cfg["pipeline"]["search"]["batch_queries"] = 1 << 14
    if prefilter:
        cfg["prefilter"] = prefilter
        cfg["pipeline"][prefilter] = PREFILTER_SECTIONS[prefilter]
    if mesh:
        cfg["pipeline"]["mesh"] = {"works": mesh[0], "script": mesh[1]}
    (dst / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())
    traffic.update(works_per_call=works, pool_calls=2, check_works=4,
                   lengths={"median": 300, "sigma": 1.2, "min": 100, "max": 5000})
    (dst / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    spec["configs"].append({"name": "tiny", "source": "a test", "file": "benchmark/configs/tiny.json",
                            "reduced": ["script"], "why": "a test"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny", "traffic": "tiny",
                              "chips": mesh[0] * mesh[1] if mesh else 1, "why": "a test"})
    like = ("canon_mesh.corpus" if mesh else "canon_bucketed.corpus" if prefilter == "bucketed"
            else "series.corpus")
    for m in spec["per_layer"]:
        if like in m["workloads"] and not (prefilter == "lsh" and m["name"].startswith("k2_")):
            m["workloads"].append(TINY_CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst / "BENCHMARK.json"


@pytest.fixture
def tiny_bench(tmp_path):
    return add_tiny_cell(tmp_path)
