#!/usr/bin/env python3
"""A/B of K5's packed Smith-Waterman route on one NVIDIA GPU: group widths, SASS, DPX rate.

    python3 scripts/torch_sw_i16_ab.py [--variants 4,8,16,8u2] [--alt-source FILE]
                                       [--works 10000] [--reps 50] [--sass-dir DIR]

Run from the root of a checkout.  Parts, each printed as one JSON line
beside the card's name and power limit:

1. toolkit: nvcc's version, and the toolkit header's declaration and
   comment of each DPX intrinsic the packed route calls (their halfword
   semantics: signed, and whether the add wraps).
2. builds: ``csrc/smith_waterman_lane.cu`` built alone with ``nvcc
   -Xptxas -v`` once per variant "G" or "GuN", a copy of the file with
   its two lines ``constexpr int kI16G = ...;`` (lanes a register of two
   pairs) and ``constexpr int kI16Unroll = ...;`` (steps a pass of the row
   loop, default 1) set to G and N, into a temporary directory; "altG..."
   rewrites ``--alt-source`` instead (another version of the file, e.g.
   from a parent checkout).  Prints ptxas's registers and spills for the
   packed kernel and the count of each SASS opcode in it (``cuobjdump
   -sass``); fails if it holds no DPX instruction (VIADDMNMX, VIMNMX,
   VIMNMX3).
3. engine pairs: chip_smoke.py's world (``make_world(0, --works)``)
   searched on the LSH path (``LSHConfig()``, ``sw_variant="fast"``), with
   K5's wrapper wrapped to keep a copy of every batch that
   ``verify_pairs`` hands it.  Prints the batches' sizes, the pairs with
   both lengths above 0, the histograms of len_a and len_b over those
   pairs, and their cells.
4. checks: every variant equal in every slot to ``sw_normalized_plain``
   at the default parameters (2, -1, -1) on chip_smoke.py's 8,192
   length-sorted 64 x 64 pairs, on the same pairs unsorted, at B 8,191 and
   1, at LA 100 x LB 200 (strips), and on every recorded engine batch.
5. times: device ms from the profiler and CUDA-event ms, in turns (K4,
   K5's f32 route, each variant, then the reverse order; the least of the
   two kept): K4 (``fs_sw``) and the f32 route (``fs_sw_lane``) as the
   library builds them, at the same integral parameters, and the packed
   route in each variant.  On the recorded engine batches (the sum over
   the batches of each batch's time: K5's device time in one LSH search),
   and on chip_smoke.py's 8,192 pairs of uniform lengths (0..64 on both
   sides).
6. the DPX rate: ``scripts/dpx_probe.cu``, built alone, times
   ``__viaddmax_s16x2_relu`` and ``__vimax3_s16x2`` (132 x 16 blocks of
   256 threads, 8 independent chains a thread) beside 132 SMs x 64 lanes
   x the boost clock, the rate at which chip_smoke.py prices the route.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DPX = ("__viaddmax_s16x2", "__viaddmax_s16x2_relu", "__vimax3_s16x2", "__vmaxs2")
DPX_SASS = ("VIADDMNMX", "VIMNMX", "VIMNMX3")
PARAMS = (2, -1, -1)  # SearchConfig's sw_match, sw_mismatch, sw_gap


def emit(key, value, card):
    print(json.dumps({key: value, "card": card}), flush=True)


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path("/usr/local/cuda/bin") / name
    if path.exists():
        return str(path)
    raise SystemExit(f"{name} not found")


def header_notes():
    """{intrinsic: the header lines that declare and describe it}."""
    inc = Path(tool("nvcc")).resolve().parents[1] / "include"
    notes = {}
    for f in sorted(inc.glob("*.h*")) + sorted(inc.glob("crt/*.h*")):
        try:
            lines = f.read_text(errors="replace").splitlines()
        except OSError:
            continue
        for i, line in enumerate(lines):
            for name in DPX:
                if name in notes or not re.search(rf"\b{name}\s*\(", line):
                    continue
                if "unsigned int" not in line:  # a declaration, not a use
                    continue
                lo = i
                while lo > 0 and i - lo < 25 and not lines[lo - 1].strip().endswith(";"):
                    lo -= 1
                notes[name] = dict(file=str(f.relative_to(inc)), line=i + 1,
                                   text=[x.strip() for x in lines[lo : i + 1] if x.strip()])
    return notes


def nvcc_so(src: Path, so: Path, extra=()):
    """nvcc ``src`` alone into the shared library ``so``, ptxas verbose;
    returns ptxas's stderr."""
    cmd = [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *extra, "-o", str(so), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"nvcc {src.name} failed:\n{res.stdout}\n{res.stderr}")
    return res.stderr


def build_variant(spec: str, tmp: Path, sass_dir=None, alt_source=None):
    """(ctypes library, ptxas lines for the packed kernel, SASS opcode
    counts) of variant ``spec``: "G", "GuN", or either after "alt"."""
    m = re.fullmatch(r"(alt)?(\d+)(?:u(\d+))?", spec)
    if not m or (m.group(1) and not alt_source):
        raise SystemExit(f"bad variant {spec!r}: G, GuN, altG or altGuN (with --alt-source)")
    g, unroll = int(m.group(2)), int(m.group(3) or 1)
    orig = (Path(alt_source) if m.group(1) else
            ROOT / "fandom_search_tpu_torch" / "csrc" / "smith_waterman_lane.cu")
    text = orig.read_text()
    for name, value in (("kI16G", g), ("kI16Unroll", unroll)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"{orig}: no single line 'constexpr int {name} = ...;'")
    src = tmp / f"sw_lane_{spec}.cu"
    src.write_text(text)
    so = tmp / f"sw_lane_{spec}.so"
    ptxas, keep = [], False
    for line in nvcc_so(src, so).splitlines():
        if "Compiling entry function" in line:
            keep = "i16" in line
        if keep and ("entry function" in line or "Used" in line or "spill" in line):
            ptxas.append(line.strip())
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"sw_lane_{spec}.sass").write_text(sass)
    counts, inside = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = m.group(1) if "i16" in m.group(1) else None
            if inside:
                counts[inside] = Counter()
            continue
        if inside:
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op:
                counts[inside][op.group(1)] += 1
    lib = ctypes.CDLL(str(so))
    fn = lib.fs_sw_lane_i16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, ptxas, {k: dict(v.most_common()) for k, v in counts.items()}


def engine_batches(works: int, device: str = "cuda"):
    """The batches that ``verify_pairs`` hands K5 when chip_smoke.py's
    world (``make_world(0, works)``) is searched on the LSH path:
    [(a, b, len_a, len_b, cells)], copies on ``device``."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops.lsh import attach_lsh_prefilter
    from fandom_search_tpu_torch.search import engine as eng

    cfg, index, world, _, _ = cs.make_world(0, works)
    lcfg = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, sw_variant="fast"))
    engine = eng.SearchEngine(index, lcfg, device=device)
    attach_lsh_prefilter(engine, LSHConfig())
    kept, scored = [], eng.sw_normalized

    def keep(a, b, len_a, len_b, c):
        kept.append(tuple(t.clone() for t in (a, b, len_a, len_b)))
        return scored(a, b, len_a, len_b, c)

    eng.sw_normalized = keep  # verify_pairs looks it up at each call
    try:
        engine.search_works(world)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        eng.sw_normalized = scored
    out = []
    for a, b, la, lb in kept:
        na = la.clamp(0, a.shape[1]).long()
        nb = lb.clamp(0, b.shape[1]).long()
        out.append((a, b, la, lb, int((na * nb).sum())))
    if not out:
        raise SystemExit("the LSH path handed K5 no batch")
    return out


def pairs_summary(batches):
    """Sizes and length histograms of the recorded engine batches."""
    import numpy as np

    la = np.concatenate([b[2].cpu().numpy() for b in batches])
    lb = np.concatenate([b[3].cpu().numpy() for b in batches])
    live = (la > 0) & (lb > 0)
    wa, wb = batches[0][0].shape[1], batches[0][1].shape[1]
    q = lambda x: [int(v) for v in np.quantile(x, (0, 0.1, 0.5, 0.9, 1))]  # noqa: E731
    return dict(
        batches=len(batches), batch_sizes=sorted({int(b[0].shape[0]) for b in batches}),
        widths=[wa, wb], pairs=int(la.size), live_pairs=int(live.sum()),
        live_per_batch=[int(((b[2] > 0) & (b[3] > 0)).sum()) for b in batches],
        len_a_quantiles=q(la[live]), len_b_quantiles=q(lb[live]),
        len_a_hist=np.bincount(la[live], minlength=wa + 1).tolist(),
        len_b_hist=np.bincount(lb[live], minlength=wb + 1).tolist(),
        cells=sum(b[4] for b in batches))


def caller(fn, A, B, LA, LB, params, scratch_rows, scratch_dtype):
    """A call of ``fn`` with its output and scratch made once."""
    import torch

    bsz, la = A.shape
    lb = B.shape[1]
    out = torch.empty((bsz,), dtype=torch.float32, device=A.device)
    lmax = max(la, lb)
    scratch = (torch.empty((scratch_rows, 2, lmax), dtype=scratch_dtype, device=A.device)
               if lmax > 64 else None)
    sp = 0 if scratch is None else scratch.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(A.data_ptr(), B.data_ptr(), LA.data_ptr(), LB.data_ptr(), out.data_ptr(), sp,
                bsz, la, lb, *params, stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return out

    call.keep = scratch
    return call


def dpx_rates(tmp: Path):
    """{intrinsic: operations a second} from ``scripts/dpx_probe.cu``:
    132 x 16 blocks of 256 threads, 8 independent chains a thread, 4096
    steps."""
    import chip_smoke as cs
    import torch

    so = tmp / "dpx_probe.so"
    nvcc_so(ROOT / "scripts" / "dpx_probe.cu", so)
    fn = ctypes.CDLL(str(so)).fs_dpx_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, iters, reps = cs.SMS * 16, 4096, 5
    out = torch.empty((blocks * 256,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for op, name in ((0, "viaddmax_s16x2_relu"), (1, "vimax3_s16x2")):
        def probe():
            if fn(out.data_ptr(), blocks, iters, op, stream) != 0:
                raise SystemExit("fs_dpx_probe failed")
        kernels, _, _ = cs.device_events(probe, reps)
        if len(kernels) != reps:
            raise SystemExit(f"{reps} probe calls ran {len(kernels)} kernels")
        rates[name] = blocks * 256 * iters * 8 / (
            sum(float(e["dur"]) for e in kernels) / reps / 1e6)
    return rates


def timed(calls, reps):
    """{key: device and event ms} of ``calls`` ({key: [call, ...]}, one
    call a batch: the sums over the batches), in turns: every key, then
    the reverse order."""
    import chip_smoke as cs

    times = {k: dict(device_ms=[], event_ms=[]) for k in calls}
    order = list(calls) + list(calls)[::-1]
    for key in order:
        dev = ev = 0.0
        for call in calls[key]:
            kernels, _, _ = cs.device_events(call, reps)
            if len(kernels) != reps:
                raise SystemExit(f"{reps} {key} calls ran {len(kernels)} kernels")
            dev += sum(float(e["dur"]) for e in kernels) / reps / 1e3
            ev += cs.cuda_ms(call, reps)
        times[key]["device_ms"].append(dev)
        times[key]["event_ms"].append(ev)
    return dict(order=order, **{
        k: dict(v, device_min=min(v["device_ms"]), event_min=min(v["event_ms"]))
        for k, v in times.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="8,16")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--works", type=int, default=10000,
                    help="works in chip_smoke.py's world for the engine pairs")
    ap.add_argument("--alt-source", default=None,
                    help="another smith_waterman_lane.cu for the alt variants")
    ap.add_argument("--sass-dir", default=None,
                    help="write each variant's whole SASS listing here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops.smith_waterman import sw_normalized_plain

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip().splitlines()[0]
    boost = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=120, check=True).stdout.strip().splitlines()[0])
    print(card, flush=True)
    ver = subprocess.run([tool("nvcc"), "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    emit("toolkit", dict(nvcc=ver, intrinsics=header_notes()), card)

    _cuda.build()
    lib = _cuda.library()
    variants = {}
    with tempfile.TemporaryDirectory() as d:
        for spec in args.variants.split(","):
            vlib, ptxas, sass = build_variant(spec, Path(d), args.sass_dir, args.alt_source)
            ndpx = sum(n for ops in sass.values() for op, n in ops.items() if op in DPX_SASS)
            emit(f"build_g{spec}", dict(ptxas=ptxas, sass=sass, dpx_instructions=ndpx), card)
            if ndpx == 0:
                raise SystemExit(f"{spec}: the packed kernel holds no DPX instruction")
            variants[f"g{spec}"] = vlib

        batches = engine_batches(args.works)
        emit("engine_pairs", dict(works=args.works, **pairs_summary(batches)), card)

        dev = "cuda"
        rng = np.random.default_rng(1)
        cases = {
            "sorted_8192": cs.sw_engine_pairs(rng, dev)[:4],
            "unsorted_8192": cs.sw_engine_pairs(rng, dev, sort=False)[:4],
            "b8191": cs.sw_engine_pairs(rng, dev, bsz=8191)[:4],
            "b1": cs.sw_engine_pairs(rng, dev, bsz=1)[:4],
            "100x200": cs.sw_pairs(rng, 4096, 100, 200, dev)[:4],
            **{f"engine_batch_{i}": b[:4] for i, b in enumerate(batches)},
        }
        for name, (A, B, LA, LB) in cases.items():
            want = sw_normalized_plain(A, B, LA, LB, *map(float, PARAMS))
            for key, vlib in variants.items():
                got = caller(vlib.fs_sw_lane_i16, A, B, LA, LB, PARAMS, (A.shape[0] + 1) // 2,
                             torch.int32)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise SystemExit(f"{key} differs from plain on {name} in {bad} slots")
        emit("checks", dict(cases=list(cases), variants=list(variants),
                            result="every slot equal to sw_normalized_plain"), card)

        fparams = tuple(map(float, PARAMS))
        for name, sets in (("engine", batches),
                           ("uniform_8192", [cs.sw_engine_pairs(np.random.default_rng(1), dev)])):
            calls = {"k4": [], "f32": [], **{k: [] for k in variants}}
            for A, B, LA, LB, _ in sets:
                bsz = A.shape[0]
                calls["k4"].append(caller(lib.fs_sw, A, B, LA, LB, fparams, bsz, torch.float32))
                calls["f32"].append(caller(lib.fs_sw_lane, A, B, LA, LB, fparams, bsz,
                                           torch.float32))
                for key, vlib in variants.items():
                    calls[key].append(caller(vlib.fs_sw_lane_i16, A, B, LA, LB, PARAMS,
                                             (bsz + 1) // 2, torch.int32))
                want = sw_normalized_plain(A, B, LA, LB, *fparams)
                for key in calls:
                    got = calls[key][-1]()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise SystemExit(f"{key} differs from plain on {name}")
            emit(f"times_{name}", dict(batches=len(sets), cells=sum(x[4] for x in sets),
                                       **timed(calls, args.reps)), card)

        rates = {name: dict(ops_per_s=r, per_sm_per_clock=r / (cs.SMS * boost * 1e6))
                 for name, r in dpx_rates(Path(d)).items()}
    emit("dpx_rate", dict(rates, alu_row_rate=cs.SMS * 64 * boost * 1e6, boost_mhz=boost), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
