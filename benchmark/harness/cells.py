"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration and traffic mix, and the metrics; each of those is a file
of its own under this folder (``configs/<name>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    bench_dir: Path
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and the metrics it reports.  Refuses a cell whose
    configuration's mesh (works x script, 1 without one) is not its
    chips."""
    bench_json = Path(bench_json or ROOT / "BENCHMARK.json")
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    root = bench_json.parent
    bench_dir = root / spec["paths"][0]
    config = json.loads((root / conf["file"]).read_text())
    mesh = config.get("pipeline", {}).get("mesh", {})
    cards = int(mesh.get("works", 1)) * int(mesh.get("script", 1))
    if cards != int(w["chips"]):
        raise ValueError(f"cell {name!r} asks for {w['chips']} chip(s), and its configuration "
                         f"{conf['name']!r} lays its mesh over {cards} card(s)")
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, bench_dir=bench_dir, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def load_module(path: Path) -> ModuleType:
    """A Python file loaded by path (metric names hold dots)."""
    name = f"_bench_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_readers(names: List[str], bench_dir: Path = BENCH_DIR) -> Dict[str, ModuleType]:
    """{metric name: its reader module, ``metrics/<name>.py``}."""
    return {n: load_module(bench_dir / "metrics" / f"{n}.py") for n in names}


def reference_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """A configuration's plain reference, ``reference/<name>.py``."""
    return load_module(bench_dir / "reference" / f"{name}.py")
