"""Traced runs: spans around the program's calls, and the reduction of
the profiler's Chrome trace to what the per-layer metrics read.

With ``--trace 1`` the harness wraps, for the run only, the program
functions that carry each layer (``Spans``): the distance top-k wrapper
(K2), the LSH prefilter's Hamming top-R (K6) and the verify scorer (K4)
get a ``record_function`` span each call that names its shapes, on one
card and on each block of a mesh, the mesh's exchange and exact merge
get ``bench.gather`` and ``bench.merge``, and the engine's host steps
get ``host.*`` spans.  Each K2 and K6 call keeps the query rows the
algorithm needs, and each K4 call the DP cells and tokens its pairs'
lengths need; what is counted on the device is read once the window has
closed.  A batch needs the shingles of its works (not the power-of-two
padding of its stream, nor the shingles across two works), and on the
bucketed hybrid those of them among the at-risk rerun's rows (not the -1
rows that pad them to the sticky budget, nor padding positions that
probe an over-cap bucket).  On a mesh each block (works slice i x
script shard j) needs the batch's work shingles inside works slice i,
against shard j's valid rows, so the blocks' bounds add up to the
one-card bound of the batch.  A launch that reruns a batch after a
budget overflow needs nothing more.
``reduce_trace`` then finds each span's kernels (and the exchange's
copies) through the correlation ids of the launches made inside it.

An H100 trace drops its first device events, more of them as a process
ages (the port's ``scripts/torch_profiler_lead.py``).  ``lead`` launches
tiny kernels ahead of the window so that the dropped ones are those;
a call whose kernel is still missing is left out of its roofline.
"""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from benchmark.harness.roofline import k2_bound_s, k4_bound_s, k6_bound_s, sw_packed

WINDOW_SPAN = "bench.window"
EXCHANGE_SPANS = ("bench.gather", "bench.merge")
LEAD_KERNELS = 256
PAD_S = 0.01
_END = object()


class Spans:
    """Installs the traced run's spans; ``with Spans() as spans:``
    restores every wrapped function on exit."""

    def __init__(self):
        self.k2_rows: List[object] = []        # int or a device scalar, per K2 call
        self.k4_work: List[torch.Tensor] = []
        self.k6_rows: List[int] = []
        self._batch_rows = 0                   # the submitted batch's, until its K2 or K6 runs
        self._batch_spans = ([], [])           # its works' first and past-last shingle
        self._risk_rows = None
        self._blocks = None                    # on a mesh: the rows of each block to launch
        self._undo: List[Tuple[object, str, object]] = []

    def _set(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self) -> "Spans":
        from fandom_search_tpu_torch.ops import bucketed, distance_topk, lsh, smith_waterman
        from fandom_search_tpu_torch.parallel import sharded
        from fandom_search_tpu_torch.search import engine

        topk, sw, hamming = distance_topk.topk_dot, smith_waterman.sw_normalized, lsh.hamming_topk
        rerun, sharded_topk = bucketed.exact_on_risk_rows, sharded.sharded_topk
        rows, work = self.k2_rows, self.k4_work

        def spanned(name, fn):
            def call(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return call

        def k2(q, s, ns_valid, k, **kw):
            if self._blocks is not None:
                rows.append(next(self._blocks))
            elif not self._batch_rows:
                rows.append(0)
            elif self._risk_rows is None:
                rows.append(self._batch_rows)
            else:
                rows.append(self._needed_among(self._risk_rows))
            self._batch_rows = 0
            with record_function(f"bench.k2|{len(rows) - 1}|{int(ns_valid)}|{q.shape[1]}|{k}"):
                return topk(q, s, ns_valid, k, **kw)

        def k6(q_codes, codes_t, ns_valid, rerank, bits, **kw):
            self.k6_rows.append(self._batch_rows)
            self._batch_rows = 0
            name = f"bench.k6|{len(self.k6_rows) - 1}|{int(ns_valid)}|{bits}|{rerank}"
            with record_function(name):
                out = hamming(q_codes, codes_t, ns_valid, rerank, bits, **kw)
            # hamming_topk counts its launches on its module name, which
            # is this wrapper while it is installed
            hamming.launches = k6.launches
            return out

        k6.launches = hamming.launches

        def risk(q_emb, risk_rows, *a, **kw):
            self._risk_rows = risk_rows
            try:
                return rerun(q_emb, risk_rows, *a, **kw)
            finally:
                self._risk_rows = None

        def blocks(mesh, q_slices, *a, **kw):
            # the blocks launch in grid order, the cells this process owns
            rows_l = next(q for q in q_slices if q is not None).shape[0]
            need, self._batch_rows = self._batch_rows, 0
            self._blocks = iter([self._needed_in(i * rows_l, (i + 1) * rows_l) if need else 0
                                 for i, row in enumerate(mesh.devices)
                                 for j in range(len(row)) if mesh.local(i, j)])
            try:
                return sharded_topk(mesh, q_slices, *a, **kw)
            finally:
                self._blocks = None

        def k4(a, b, len_a, len_b, cfg):
            na = len_a.long().clamp(0, a.shape[1])
            nb = len_b.long().clamp(0, b.shape[1])
            work.append(torch.stack([(na * nb).sum(), na.sum() + nb.sum()]))
            packed = sw_packed(cfg.sw_match, cfg.sw_mismatch, cfg.sw_gap, a.shape[1], b.shape[1])
            with record_function(f"bench.k4|{len(work) - 1}|{a.shape[0]}|{int(packed)}"):
                return sw(a, b, len_a, len_b, cfg)

        self._set(engine, "topk_dot", k2)
        self._set(bucketed, "topk_dot", k2)
        self._set(bucketed, "exact_on_risk_rows", risk)
        self._set(engine, "sw_normalized", k4)
        self._set(lsh, "hamming_topk", k6)
        self._set(sharded, "sharded_topk", blocks)
        self._set(sharded, "topk_dot", k2)
        self._set(sharded, "sw_normalized", k4)
        self._set(sharded, "merge_topk", spanned("bench.merge", sharded.merge_topk))
        self._set(sharded, "gather", spanned("bench.gather", sharded.gather))

        cls = engine.SearchEngine
        batches, process, submit = cls._batches, cls._process_fused, cls._submit_fused
        chain = engine.chain_hits_arrays

        def traced_batches(self_, items):
            gen = batches(self_, items)
            while True:
                with record_function("host.batchgen"):
                    nxt = next(gen, _END)
                if nxt is _END:
                    return
                yield nxt

        def traced_submit(self_, payload, nspans, spans, *a, **kw):
            n = self_.cfg.shingle.n
            self._batch_rows = sum(max(0, m - n + 1) for _, _, m in spans)
            self._batch_spans = ([o for _, o, _ in spans], [o + m - n + 1 for _, o, m in spans])
            with record_function("host.submit"):
                return submit(self_, payload, nspans, spans, *a, **kw)

        self._set(cls, "_batches", traced_batches)
        self._set(cls, "_process_fused", spanned("host.pull_post", process))
        self._set(cls, "_submit_fused", traced_submit)
        self._set(engine, "chain_hits_arrays", spanned("host.chain", chain))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()
        return False

    def _needed_among(self, pos: torch.Tensor) -> torch.Tensor:
        """How many of the stream positions ``pos`` (-1 for none) start a
        shingle inside one work of the submitted batch, on the device."""
        starts, ends = (torch.tensor(x, dtype=torch.long, device=pos.device)
                        for x in self._batch_spans)
        p = pos.long()
        i = (torch.searchsorted(starts, p, right=True) - 1).clamp(min=0)
        return ((p >= starts[i]) & (p < ends[i])).sum()

    def _needed_in(self, lo: int, hi: int) -> int:
        """How many of the stream positions ``lo`` to ``hi`` start a
        shingle inside one work of the submitted batch."""
        return sum(max(0, min(e, hi) - max(s, lo)) for s, e in zip(*self._batch_spans))

    def counts(self) -> Tuple[List[int], List[Tuple[int, int]]]:
        """The query rows of each K2 call, and (cells, tokens) of each
        K4 call, read from the device."""
        return ([int(r) for r in self.k2_rows],
                [tuple(int(x) for x in t.tolist()) for t in self.k4_work])


def lead(devices) -> None:
    """Tiny kernels on each device ahead of the traced window, then a
    pause so the device clock's offset falls outside it."""
    for d in devices:
        if d.type == "cuda":
            x = torch.zeros((1,), device=d)
            for _ in range(LEAD_KERNELS):
                x.add_(1)
            torch.cuda.synchronize(d)
    time.sleep(PAD_S)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: Dict[int, float]                     # device index -> busy seconds
    ops: Dict[str, float]                        # device op name -> seconds, all devices
    gaps: Dict[str, float]                       # host span -> idle seconds, mean over devices
    k2: List[Tuple[float, float]] = field(default_factory=list)   # (bound s, kernel s)
    k4: List[Tuple[float, float]] = field(default_factory=list)
    k6: List[Tuple[float, float]] = field(default_factory=list)
    # the stream's card's seconds in the mesh's exchange and merge (None: no such span)
    exchange_s: float | None = None

    @property
    def devices(self) -> int:
        return len(self.busy_s)

    @property
    def mean_busy_s(self) -> float:
        return sum(self.busy_s.values()) / max(1, len(self.busy_s))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _launched(span, runtime_by_tid, by_corr):
    """The device events whose launches fall inside the host span."""
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    ts, evs = runtime_by_tid.get(span.get("tid"), ([], []))
    for e in evs[bisect.bisect_left(ts, t0):bisect.bisect_right(ts, t1)]:
        yield from by_corr.get(e.get("args", {}).get("correlation"), ())


def _span_kernels(spans, runtime_by_tid, by_corr, pattern: str):
    """Per span, the summed duration (us) of the kernels named like
    ``pattern`` whose launches fall inside it; None where none landed."""
    out = []
    for s in spans:
        found = [float(k["dur"]) for k in _launched(s, runtime_by_tid, by_corr)
                 if k.get("cat") == "kernel" and pattern in k["name"]]
        out.append(sum(found) if found else None)
    return out


def _card(event) -> int:
    """The card whose stream ran a device event: a peer copy names it
    ``inDevice`` (its source), every other event ``device``."""
    args = event.get("args", {})
    return int(args.get("device", args.get("inDevice", 0)))


def _on_card(event, card: int) -> bool:
    """Whether a device event ran on ``card`` or, as a peer copy, landed
    there."""
    return card in (_card(event), event.get("args", {}).get("toDevice"))


def reduce_trace(path: Path, devices: List[int], k2_rows: List[int],
                 k4_counts: List[Tuple[int, int]], k6_rows: List[int] = ()) -> TraceSummary:
    """The traced window's busy time per device, its device ops by name,
    its idle gaps by the host span they fell in, and each K2, K4 and K6
    call's bound beside its kernel time.  ``devices`` lists the cards'
    indices, the stream's first: its ``exchange_s`` is the device time
    of the kernels and copies launched inside the ``bench.gather`` and
    ``bench.merge`` spans that ran on it or landed there."""
    events = json.loads(Path(path).read_text(encoding="utf-8")).get("traceEvents", [])
    ann = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    win = [e for e in ann if e.get("name") == WINDOW_SPAN]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW_SPAN} spans")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev_events = [e for e in events if e.get("cat") in _DEVICE_CATS and "dur" in e]
    per_dev = defaultdict(list)
    ops = defaultdict(float)
    for e in dev_events:
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if b > a:
            per_dev[_card(e)].append((a, b))
            ops[e["name"]] += (b - a) / 1e6
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in ann
                   if e["name"].startswith("host.")), key=lambda x: x[0])
    starts = [h[0] for h in host]
    busy, gaps = {}, defaultdict(float)
    for d in devices:
        merged = _union(per_dev.get(d, []))
        busy[d] = sum(b - a for a, b in merged) / 1e6
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, label = (a + b) / 2, "host.other"
            for h in reversed(host[:bisect.bisect_right(starts, mid)]):
                if h[1] >= mid:
                    label = h[2]
                    break
            gaps[label] += (b - a) / 1e6 / max(1, len(devices))
    runtime = defaultdict(list)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            runtime[e.get("tid")].append(e)
    runtime_by_tid = {}
    for tid, evs in runtime.items():
        evs.sort(key=lambda e: float(e["ts"]))
        runtime_by_tid[tid] = ([float(e["ts"]) for e in evs], evs)
    by_corr = defaultdict(list)
    for e in dev_events:
        if w0 <= float(e["ts"]) <= w1:
            by_corr[e.get("args", {}).get("correlation")].append(e)

    def calls(prefix):
        spans = [e for e in ann if e["name"].startswith(prefix) and w0 <= float(e["ts"]) <= w1]
        return spans, [s["name"].split("|")[1:] for s in spans]

    summary = TraceSummary((w1 - w0) / 1e6, busy, dict(ops), dict(gaps))
    spans, shapes = calls("bench.k2|")
    for us, (i, ns, dim, k) in zip(_span_kernels(spans, runtime_by_tid, by_corr,
                                                 "topk_kernel"), shapes):
        if us:
            nq = k2_rows[int(i)]
            summary.k2.append((k2_bound_s(nq, int(ns), int(dim), int(k)), us / 1e6))
    spans, shapes = calls("bench.k4|")
    for us, (i, pairs, packed) in zip(_span_kernels(spans, runtime_by_tid, by_corr,
                                                    "sw_kernel"), shapes):
        if us:
            cells, tokens = k4_counts[int(i)]
            summary.k4.append((k4_bound_s(cells, tokens, int(pairs), packed == "1"), us / 1e6))
    spans, shapes = calls("bench.k6|")
    for us, (i, ns, bits, r) in zip(_span_kernels(spans, runtime_by_tid, by_corr,
                                                  "hamming_topk_tc"), shapes):
        if us:
            summary.k6.append((k6_bound_s(k6_rows[int(i)], int(ns), int(bits), int(r)),
                               us / 1e6))
    exchange = [e for e in ann if e["name"] in EXCHANGE_SPANS and w0 <= float(e["ts"]) <= w1]
    if exchange and devices:
        summary.exchange_s = sum(float(k["dur"]) for s in exchange
                                 for k in _launched(s, runtime_by_tid, by_corr)
                                 if _on_card(k, devices[0])) / 1e6
    return summary
