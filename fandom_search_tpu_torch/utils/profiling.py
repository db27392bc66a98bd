"""Tracing and stage timing; counterpart of fandom_search_tpu/utils/profiling.py.

  * ``device_trace(dir, device)`` — a ``torch.profiler`` context (CPU
    activity, plus CUDA activity when ``device`` is a CUDA device) that
    writes ``dir/trace.json``, a Chrome trace of every op and kernel
    launch (chrome://tracing or ui.perfetto.dev);
  * ``busy_share(trace)`` — kernel time over the traced wall time, read
    from such a trace;
  * ``Tracer`` — the engine's timers and counters of one ``search_works``
    call, summed into its ``EngineStats``; while the profiler records,
    its host spans are ``record_function`` spans on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(out_dir: str | Path, device="cuda") -> Iterator[None]:
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


def tracing() -> bool:
    """Whether the torch profiler is recording (0.2 us a check, against
    12.5 us for an idle ``record_function``)."""
    return torch.autograd._profiler_enabled()


class Tracer:
    """The timers and counters of one ``search_works`` call, summed into
    ``stats`` (an ``EngineStats``): a key that names one of its fields
    adds to that field, any other key to ``stats.extra``.

    ``on`` is whether the profiler records (``tracing()``, read once a
    call).  Then every host span is also a ``record_function`` span on
    the profiler's clock, beside the device events, and ``device`` times
    a stretch of device work with CUDA events.  Spans are opened on the
    caller's thread only: a trace reader that reads every thread would
    give a worker's span the idle gaps of the caller's timeline.
    """

    def __init__(self, stats, device, on: bool = False):
        self.stats = stats
        self.on = on
        self._device = torch.device(device)
        self._events: List[Tuple[object, torch.cuda.Event, torch.cuda.Event]] = []

    def add(self, keys, amount: float) -> None:
        """Add ``amount`` under ``keys`` (a key or a tuple of keys)."""
        for key in (keys,) if isinstance(keys, str) else keys:
            if key != "extra" and hasattr(self.stats, key):
                setattr(self.stats, key, getattr(self.stats, key) + amount)
            else:
                self.stats.extra[key] = self.stats.extra.get(key, 0.0) + amount

    @contextlib.contextmanager
    def host(self, name: str, keys) -> Iterator[None]:
        """The block's host seconds under ``keys``; the span ``name``
        while tracing."""
        t0 = time.perf_counter()
        try:
            if self.on:
                with record_function(name):
                    yield
            else:
                yield
        finally:
            self.add(keys, time.perf_counter() - t0)

    @contextlib.contextmanager
    def device(self, name: str, keys) -> Iterator[None]:
        """The device seconds of the work the block launches, under
        ``keys``, with no sync.  On a CUDA device while tracing (and not
        otherwise): a timing event pair on the device's current stream,
        read by ``resolve`` once the stream has passed it, and the host
        span ``name``.  On the CPU the ops run as they are called: the
        block's host seconds, as ``host``."""
        if self._device.type != "cuda":
            with self.host(name, keys):
                yield
            return
        if not self.on:
            yield
            return
        stream = torch.cuda.current_stream(self._device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with record_function(name):
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
        self._events.append((keys, start, end))

    def resolve(self, wait: bool = False) -> None:
        """Add the device stretches whose end event the stream has passed
        (a pull has synchronized it); with ``wait``, every one."""
        left = []
        for keys, start, end in self._events:
            if wait:
                end.synchronize()
            if wait or end.query():
                self.add(keys, start.elapsed_time(end) / 1e3)
            else:
                left.append((keys, start, end))
        self._events = left
