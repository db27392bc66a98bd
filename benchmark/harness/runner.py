"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the comparison with the plain reference.

The window is a closed loop with one caller: each call hands
``search_works`` the next ``works_per_call`` works of the pool under ids
of its own, and the loop ends after the call in progress once
``seconds`` have passed.  ``search_words_per_s`` is every word of every
call over the time from the window's start to the end of the last call.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import tempfile
import time
from collections import namedtuple
from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import cells, world
from benchmark.harness.imports import forbidden_modules

MB = 1 << 20
CONTROL_CALLS = 8


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: cells.Cell
    window_s: float
    calls: List[dict]
    trace: object = None       # trace.TraceSummary of a traced run


def card_line() -> str:
    """The cards' names and power limits as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def _sample_positions(seed: int, call_no: int, lengths: np.ndarray, count: int) -> List[int]:
    """The positions of a call whose rows are kept for the comparison:
    ``count`` drawn from the seed, and the call's longest work."""
    pos = world.shuffled(world.rng_for(seed, 2, call_no), len(lengths))[:count].tolist()
    longest = int(np.argmax(lengths))
    return pos if longest in pos else pos + [longest]


def _window(engine, pool, seed: int, seconds: float, check_works: int, first_call: int):
    """The closed loop; returns (calls, window seconds, kept rows by
    (call, position))."""
    calls, kept = [], {}
    t0 = time.perf_counter()
    c = first_call
    while True:
        works = world.call_works(pool, c)
        rows, st = engine.search_works(works)
        elapsed = time.perf_counter() - t0
        entry = pool[c % len(pool)]
        keep = {world.work_id(c, j): j for j in
                _sample_positions(seed, c, entry.words, check_works)}
        by_work: Dict[str, list] = {w: [] for w in keep}
        for r in rows:
            if r.work_id in by_work:
                by_work[r.work_id].append(r)
        for w, j in keep.items():
            kept[(c, j)] = by_work[w]
        calls.append({"call": c, "works": len(works), "words": entry.total_words,
                      "end_s": elapsed, "rows": len(rows), "extra": dict(st.extra)})
        c += 1
        if elapsed >= seconds:
            return calls, elapsed, kept


def compare(ref_mod, script_text: str, config: dict, pool, kept: dict, seed: int,
            check_works: int, device) -> Dict[str, dict]:
    """The rows the timed calls returned for a seeded sample of works
    (the first call's longest work among them), against the plain
    reference's rows of the same texts: rows the program missed and rows
    it added, each with its limit."""
    t0 = time.perf_counter()
    ref = ref_mod.Reference(script_text, config.get("pipeline", {}), device=device)
    log(f"reference script {time.perf_counter() - t0:.3f}s")
    keys = sorted(kept)
    order = world.shuffled(world.rng_for(seed, 3), len(keys))
    first = keys[0][0]
    longest = (first, int(np.argmax(pool[first % len(pool)].words)))
    chosen, seen = [longest], {(longest[0] % len(pool), longest[1])}
    for i in order.tolist():
        c, j = keys[i]
        if len(chosen) > check_works:
            break
        if (c % len(pool), j) not in seen:
            seen.add((c % len(pool), j))
            chosen.append((c, j))
    missing = extra = rows = 0
    for c, j in chosen:
        got = {ref_mod.row_of(r) for r in kept[(c, j)]}
        want = set(ref.rows(world.work_id(c, j), pool[c % len(pool)].texts[j]))
        missing += len(want - got)
        extra += len(got - want)
        rows += len(want)
    log(f"compared {len(chosen)} works, {rows} reference rows")
    return {"rows_missing": {"value": missing, "limit": 0},
            "rows_extra": {"value": extra, "limit": 0}}


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: float | None = None, bench_json: Path | None = None) -> dict:
    """Run one cell once; returns the result line's object.  Raises
    ``ForbiddenImport`` if JAX or the JAX package was loaded."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cells.load_cell(workload, bench_json)
    bench_dir = cell.bench_dir
    cfg, traffic = cell.config, cell.traffic
    from benchmark.harness import system
    from benchmark.harness import trace as tr

    phases: Dict[str, float] = {}
    phases["kernels"] = system.load_kernels(device)
    t0 = time.perf_counter()
    vocab, script, ranks = world.make_script_world(seed, cfg["script"])
    phases["script"] = time.perf_counter() - t0
    spans = tr.Spans().__enter__() if trace else None
    try:
        engine = system.build_engine(script.text, cfg, device, phases)
        devices = system.engine_devices(engine)
        t0 = time.perf_counter()
        pool = world.make_pool(seed, vocab, script, ranks, traffic)
        phases["pool"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.search_works(world.call_works(pool, 0))
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        phases["warmup"] = time.perf_counter() - t0
        gc.collect()
        gc.freeze()
        check_works = int(traffic["check_works"])
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            tr.lead(devices)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            time.sleep(tr.PAD_S)
        setup_s = time.perf_counter() - t_start
        if trace:
            with torch.profiler.record_function(tr.WINDOW_SPAN):
                calls, window_s, kept = _window(engine, pool, seed, seconds, check_works, 1)
                for d in devices:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            time.sleep(tr.PAD_S)
            prof.__exit__(None, None, None)
        else:
            calls, window_s, kept = _window(engine, pool, seed, seconds, check_works, 1)
        forbidden_modules(raise_if_any=True)
        peaks = [torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"]
        peak = max(peaks, default=0)
        k2_rows, k4_counts = spans.counts() if spans else ([], [])
        k6_rows = spans.k6_rows if spans else []
    finally:
        if spans:
            spans.__exit__(None, None, None)
    words = sum(c["words"] for c in calls)
    wraps = sum(1 for c in calls if c["call"] % len(pool) == 0)
    log("setup " + " ".join(f"{k}={v:.3f}s" for k, v in phases.items())
        + f" total={setup_s:.3f}s")
    log(f"window calls={len(calls)} words={words} seconds={window_s:.3f} pool_calls={len(pool)} "
        f"pool_wraps={wraps} rows={sum(c['rows'] for c in calls)} "
        f"memory_peak={peak / MB:.1f}MiB"
        + (f" per_card={'/'.join(f'{b / MB:.1f}' for b in peaks)}MiB" if len(peaks) > 1 else ""))
    log(f"cards: {card_line() if device != 'cpu' else 'cpu'}")

    result = {"correct": False, "attempted": sum(c["works"] for c in calls), "failed": 0}
    summary = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            idx = [d.index or 0 for d in devices] if device != "cpu" else []
            summary = tr.reduce_trace(path, idx, k2_rows, k4_counts, k6_rows)
        ctx = Context(cell, window_s, calls, summary)
        readers = cells.metric_readers([m["name"] for m in cell.per_layer], bench_dir)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            elif device != "cpu" or m["source"] != "device_trace":
                # the cell lists the metric, so its layer ran: a reader
                # that finds nothing has lost its spans or its kernels
                raise RuntimeError(f"{cell.name} lists {m['name']}, and its reader found "
                                   "nothing in the traced run")
    else:
        values = {"search_words_per_s": words / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": len(devices), "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.mean_busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["device"] = dev

    # the program's state goes before the reference runs, so that the
    # reference neither shares the device with it nor sets the peak
    del engine
    spans = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    ref_mod = cells.reference_module(cfg.get("reference", "exact_search"), bench_dir)
    ref_dev = "cpu" if device == "cpu" else devices[0]
    ref_mod.disable_tf32()
    t0 = time.perf_counter()
    checks = compare(ref_mod, script.text, cfg, pool, kept, seed, check_works, ref_dev)
    log(f"reference {time.perf_counter() - t0:.3f}s")
    gc.unfreeze()
    result["correct"] = verdict(checks)
    result["checks"] = checks
    return result


def verdict(checks: Dict[str, dict]) -> bool:
    """Whether every compared number lies within its limit; logs each
    beside its limit."""
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return all(c["value"] <= c["limit"] for c in checks.values())


_Match = namedtuple("_Match", "work_id fan_token_start fan_token_end fan_char_start fan_char_end "
                              "line_no score verify_score num_shingles")


class _ControlRows(Mapping):
    """The rows a run would keep, by (call, position), made by the
    control's reference when ``compare`` reads them."""

    def __init__(self, low, pool, seed: int, calls: int, check_works: int):
        self.low, self.pool = low, pool
        self._keys = [(c, j) for c in range(1, calls + 1)
                     for j in _sample_positions(seed, c, pool[c % len(pool)].words, check_works)]

    def __getitem__(self, key):
        c, j = key
        text = self.pool[c % len(self.pool)].texts[j]
        return [_Match(*r) for r in self.low.rows(world.work_id(c, j), text)]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)


def control(workload: str, seed: int, *, device: str = "cuda",
            bench_json: Path | None = None) -> dict:
    """The control of the comparison that decides ``correct``, at the
    cell's own size: the plain reference in bfloat16 (one step below the
    float32 of the candidate and alignment scores) put in the program's
    place.  Its rows stand in for those ``CONTROL_CALLS`` timed calls
    would keep (about as many as a run's window holds), and go through
    ``compare`` and ``verdict`` as a run's do; a sound comparison reads
    ``correct`` false."""
    cell = cells.load_cell(workload, bench_json)
    cfg, traffic = cell.config, cell.traffic
    ref_mod = cells.reference_module(cfg.get("reference", "exact_search"), cell.bench_dir)
    ref_mod.disable_tf32()
    vocab, script, ranks = world.make_script_world(seed, cfg["script"])
    pool = world.make_pool(seed, vocab, script, ranks, traffic)
    check_works = int(traffic["check_works"])
    low = ref_mod.Reference(script.text, cfg.get("pipeline", {}), device=device,
                            precision="bfloat16")
    kept = _ControlRows(low, pool, seed, CONTROL_CALLS, check_works)
    t0 = time.perf_counter()
    checks = compare(ref_mod, script.text, cfg, pool, kept, seed, check_works, device)
    log(f"control reference {time.perf_counter() - t0:.3f}s")
    return {"correct": verdict(checks), "checks": checks}
