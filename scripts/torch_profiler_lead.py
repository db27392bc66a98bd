#!/usr/bin/env python3
"""How many of a torch.profiler trace's first device events go missing as a process ages.

    python3 scripts/torch_profiler_lead.py [--seconds 240] [--gap 5] [--lead 0,32,256]

Run from the root of a checkout, on one NVIDIA GPU.  Every ``--gap``
seconds for ``--seconds``, it takes one trace per value L of ``--lead``:
L tiny kernels (``lead.add_(1)``), then one measured kernel (``x.mul_``
on 2^20 floats) inside a record_function span, with ``chip_smoke.py``'s
``PROFILE_PAD_S`` of host sleep at both ends.  For each trace it prints,
beside the process's age in seconds, the lead kernels the trace kept and
whether it kept the measured kernel, matched to its launch by
correlation id as ``chip_smoke.py``'s ``device_events`` matches them.
The card's name and power limit come first.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_trace(x, lead, n_lead: int, pad_s: float):
    """(lead kernels kept, measured kernel kept) of one trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(n_lead):
            lead.add_(1)
        with record_function("measured"):
            x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "measured")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    ids = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") == "cuda_runtime" and t0 <= float(e["ts"]) <= t1}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mine = sum(e.get("args", {}).get("correlation") in ids for e in kernels)
    return len(kernels) - mine, mine == 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--gap", type=float, default=5.0)
    ap.add_argument("--lead", default="0,32,256")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    x = torch.randn(1 << 20, device="cuda")
    lead = torch.zeros((1,), device="cuda")
    x.mul_(1.0)
    torch.cuda.synchronize()
    leads = [int(v) for v in args.lead.split(",")]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        row = {"age_s": round(time.perf_counter() - t0, 1)}
        for n in leads:
            kept, measured = one_trace(x, lead, n, cs.PROFILE_PAD_S)
            row[f"lead_{n}"] = {"lead_kept": kept, "measured_kept": measured}
        print(json.dumps(row), flush=True)
        time.sleep(args.gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
