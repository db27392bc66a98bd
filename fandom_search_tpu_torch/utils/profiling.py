"""Tracing and stage timing; counterpart of fandom_search_tpu/utils/profiling.py.

  * ``device_trace(dir, device)`` — a ``torch.profiler`` context (CPU
    activity, plus CUDA activity when ``device`` is a CUDA device) that
    writes ``dir/trace.json``, a Chrome trace of every op and kernel
    launch (chrome://tracing or ui.perfetto.dev);
  * ``busy_share(trace)`` — kernel time over the traced wall time, read
    from such a trace;
  * ``StageTimer`` — wall-clock per-stage accounting; a stage given a
    CUDA tensor as ``sync`` ends with a synchronize of its device.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(out_dir: str | Path, device="cuda") -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    # the trace is written even when the traced run fails
    try:
        with prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize(device)
    finally:
        prof.export_chrome_trace(str(out / TRACE_NAME))


def busy_share(trace: str | Path) -> Dict[str, float]:
    """Device busy share of a ``device_trace`` trace: the summed duration
    of its kernel events (one stream, so they do not overlap) over the
    span from the first traced event to the last.  Times in ms."""
    events = json.loads(Path(trace).read_text(encoding="utf-8"))["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    busy = sum(float(e["dur"]) for e in kernels)
    wall = t1 - t0
    return {"kernels": len(kernels), "kernel_ms": busy / 1e3, "wall_ms": wall / 1e3,
            "busy_share": busy / wall if wall > 0 else 0.0}


class StageTimer:
    """Accumulating per-stage timer: with timer('topk'): ..."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.device.type == "cuda":
                import torch

                torch.cuda.synchronize(sync.device)
            self.seconds[stage] += time.perf_counter() - t0
            self.calls[stage] += 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"seconds": round(v, 4), "calls": self.calls[k]}
            for k, v in sorted(self.seconds.items())
        }
