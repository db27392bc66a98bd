#!/usr/bin/env python3
"""How often a short torch.profiler trace of one kernel holds no device event.

    python3 scripts/torch_profiler_window.py [--trials 1500] [--pad-ms 1,10]

Run from the root of a checkout, on one NVIDIA GPU.  ``chip_smoke.py``
takes a kernel's device time from a torch.profiler Chrome trace of one
call, then of 50 (``device_events``, which sleeps ``PROFILE_PAD_S`` at
both ends of the span: the pad this script chose).  It repeats the one-call
trace of K4 (``sw_wide`` on chip_smoke.py's 8,192 length-sorted 64 x 64
pairs, about 21 us of device time) ``--trials`` times in each of these
forms, taken in turns:

- "bare": profile, one call, ``torch.cuda.synchronize()``, stop;
- "pad_P": the same with P ms of host sleep after the profiler starts
  and again after the synchronize, so that the capture window reaches
  that far past the kernel on both sides (one form for each P in
  ``--pad-ms``).

For each form it prints, as one JSON line beside the card's name and
power limit, the traces that held no kernel event (and the event
categories of the first few of them), the traces that held more than
one, and for the others the kernel's start less its ``cudaLaunchKernel``
start and the synchronize's end less the kernel's end (us, on the
trace's clock: their least values say how close the kernel came to the
capture window's edges).

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_trace(fn, pad_s: float):
    """(kernel events, runtime events, all events) of one profiled call
    of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if pad_s:
            time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return ([e for e in events if e.get("cat") == "kernel"],
            [e for e in events if e.get("cat") == "cuda_runtime"], events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=1500)
    ap.add_argument("--pad-ms", default="1,10")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from fandom_search_tpu_torch import PipelineConfig
    from fandom_search_tpu_torch.ops.smith_waterman import sw_wide

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    xc = PipelineConfig().search
    A, B, LA, LB, _ = cs.sw_engine_pairs(np.random.default_rng(0), "cuda")
    fn = lambda: sw_wide(A, B, LA, LB, xc)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    forms = {"bare": 0.0, **{f"pad_{p}": float(p) / 1e3 for p in args.pad_ms.split(",")}}
    res = {k: dict(empty=0, more=0, trials=0, empty_cats=[], launch_to_start_us=[],
                   end_to_sync_end_us=[]) for k in forms}
    t0 = time.perf_counter()
    for _ in range(args.trials):
        for form, pad in forms.items():
            kernels, runtime, events = one_trace(fn, pad)
            r = res[form]
            r["trials"] += 1
            if not kernels:
                r["empty"] += 1
                if len(r["empty_cats"]) < 5:
                    r["empty_cats"].append(dict(Counter(str(e.get("cat")) for e in events)))
                continue
            r["more"] += len(kernels) > 1
            k = kernels[-1]
            launch = [e for e in runtime if "LaunchKernel" in e.get("name", "")]
            sync = [e for e in runtime if "Synchronize" in e.get("name", "")]
            if launch:
                r["launch_to_start_us"].append(float(k["ts"]) - float(launch[-1]["ts"]))
            if sync:
                r["end_to_sync_end_us"].append(
                    float(sync[-1]["ts"]) + float(sync[-1]["dur"])
                    - float(k["ts"]) - float(k["dur"]))
    for form, r in res.items():
        summary = {k: r[k] for k in ("empty", "more", "trials", "empty_cats")}
        for key in ("launch_to_start_us", "end_to_sync_end_us"):
            v = np.asarray(r[key]) if r[key] else np.zeros(1)
            summary[key] = dict(min=float(v.min()), p01=float(np.quantile(v, 0.01)),
                                median=float(np.median(v)), n=len(r[key]))
        print(json.dumps({"profiler_window": {form: summary}, "card": card}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
