#!/usr/bin/env python3
"""A/B of the port's int8 distance top-k kernels (K2, K7) on one NVIDIA GPU.

    python3 scripts/torch_topk_ab.py [--parent DIR] [--works 700]

Run from the root of a checkout.  Every time is a warm CUDA-event mean on
the first 2^20-row batch of chip_smoke.py's world (``make_world(0,
--works)``) against its 19,033 script rows, k 10, min_keep 3.5 ("full"),
and on the padding batch: the same tokens with the last 30% set to zero,
as the engine pads a partial batch ("pad").

1. Floors: copies of ``csrc/distance_topk.cu``, built with nvcc into a
   temporary directory, whose warpgroup-MMA K2 (the engine's shape) has
   its epilogue cut short: "mma" keeps only the TMA ring and the wgmma
   products, "epilogue" adds the common path (row maxima, gate compares,
   one vote a step) but never merges.  They are timed in turns with K2
   and K7 as built.  The floors' outputs are not a top-k and are not
   compared; K2's and K7's equal the plain version in every slot, or the
   script fails.
2. ``--parent DIR``: another checkout (e.g. ``git archive`` of the parent
   commit, unpacked) timed against this one in separate processes, in
   turns (parent, this, this, parent): K2, K7, K6's b1 route, and K2 on
   the mma.sync producer at dim 256 (the batch's rows twice over) and at
   k 64 (2^14 rows).

Prints one JSON line per measurement, beside the card's name and power
limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (anchor, replacement) edits of csrc/distance_topk.cu's topk_kernel_wgmma
# for each floor (its products are asm volatile, so they stay)
_MMA_ONLY = [
    ("    unsigned mine = 0;", "    if (c0 >= 0) return;\n    unsigned mine = 0;"),
]
_EPILOGUE_ONLY = [
    ("    if (!need) return;", "    if (!need || c0 >= 0) return;"),
]
FLOORS = {"mma": _MMA_ONLY, "epilogue": _EPILOGUE_ONLY}


def world(works: int):
    """(engine, q of the full batch, q of the padding batch, torch)."""
    import chip_smoke as cs
    import torch

    from fandom_search_tpu_torch.ops.embed import embed_shingles
    from fandom_search_tpu_torch.search.engine import SearchEngine

    cfg, index, w, _, _ = cs.make_world(0, works)
    engine = SearchEngine(index, cfg, device="cuda")
    tok = cs.first_batch_stream(engine, w)
    q = embed_shingles(tok, engine._dix.mults)
    tok[int(0.7 * tok.shape[0]):] = 0
    return engine, q, embed_shingles(tok, engine._dix.mults), torch


def build_floor(name: str, tmp: Path):
    from fandom_search_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "distance_topk.cu").read_text()
    for old, new in FLOORS[name]:
        if old not in src:
            raise SystemExit(f"floor {name}: anchor not found in distance_topk.cu: {old!r}")
        src = src.replace(old, new, 1)
    d = tmp / name
    d.mkdir()
    (d / "distance_topk.cu").write_text(src)
    (d / "int8_tiles.cuh").write_text((_cuda.CSRC / "int8_tiles.cuh").read_text())
    cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-o", str(d / "lib.so"), str(d / "distance_topk.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def floors(works: int) -> dict:
    import chip_smoke as cs
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops.distance_topk import (
        min_keep_int, topk_dot, topk_dot_plain, wgmma_splits,
    )

    with tempfile.TemporaryDirectory() as t:
        jobs = {n: build_floor(n, Path(t)) for n in FLOORS}
        _cuda.build()
        libs = {}
        for name, (proc, d) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"nvcc failed on floor {name}:\n{out}")
            fn = ctypes.CDLL(str(d / "lib.so")).fs_topk_wgmma
            fn.argtypes = _cuda._SIGNATURES["fs_topk_wgmma"]
            fn.restype = ctypes.c_int
            libs[name] = fn
        engine, q, qp, torch = world(works)
        cfg = engine.cfg
        s = engine._dix.s_emb
        ns, k, thr = s.shape[0], cfg.search.k, cfg.search.candidate_threshold
        keep = min_keep_int(thr, cfg.shingle.dim)
        stream = torch.cuda.current_stream().cuda_stream
        batches = {"full": q, "pad": qp}

        sms = _cuda.sm_count(q.device)

        def floor_call(fn, qq):
            v = torch.empty((qq.shape[0], k), dtype=torch.float32, device="cuda")
            i = torch.empty((qq.shape[0], k), dtype=torch.int32, device="cuda")
            splits = wgmma_splits(qq.shape[0], ns, sms)
            part = torch.empty((splits, qq.shape[0], k), dtype=torch.int64, device="cuda")
            rc = fn(qq.data_ptr(), s.data_ptr(), v.data_ptr(), i.data_ptr(), qq.shape[0], ns,
                    cfg.shingle.dim, k, keep, 1.0 / cfg.shingle.dim, part.data_ptr(), splits,
                    stream)
            _cuda.check(rc, "floor")

        calls = {
            "K2": lambda qq: topk_dot(qq, s, ns, k, min_keep=thr),
            "K7": lambda qq: topk_dot(qq, s, ns, k, min_keep=thr, merge="rows"),
            **{f"floor_{n}": (lambda qq, fn=fn: floor_call(fn, qq)) for n, fn in libs.items()},
        }
        for b, qq in batches.items():
            want = topk_dot_plain(qq, s, ns, k, keep)
            for name in ("K2", "K7"):
                got = calls[name](qq)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{name} differs from the plain version on the {b} batch")
        times = {n: {b: [] for b in batches} for n in calls}
        for name in list(calls) + list(calls)[::-1]:
            for b, qq in batches.items():
                times[name][b].append(cs.cuda_ms(lambda: calls[name](qq), 5))
        return {"floors": {"shape": f"NQ={q.shape[0]} NS={ns} k={k} min_keep={thr}",
                           "ms": times}}


def one_tree(tree: Path, works: int) -> dict:
    """K2, K7 and K6 (b1) times of the checkout at ``tree`` (run in a
    process of its own, with ``tree`` first on sys.path)."""
    import chip_smoke as cs
    from fandom_search_tpu_torch import LSHConfig
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.ops.distance_topk import topk_dot
    from fandom_search_tpu_torch.ops.lsh import (
        LSHIndex, coarse_sim_threshold, encode, hamming_topk,
    )

    if not Path(_cuda.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"loaded {_cuda.__file__}, not the package under {tree}")
    _cuda.build()
    engine, q, qp, torch = world(works)
    cfg = engine.cfg
    s = engine._dix.s_emb
    ns, k, thr = s.shape[0], cfg.search.k, cfg.search.candidate_threshold
    lcfg = LSHConfig()
    lsh = LSHIndex.build(engine.index.embeddings, lcfg, cfg.shingle,
                         pad_multiple=cfg.search.script_pad_multiple, device="cuda")
    codes = encode(q, lsh.projection)
    keep = coarse_sim_threshold(thr, cfg.shingle.n, lcfg.bits)
    # the mma.sync producer's shapes: dim 256 (each row twice over) and k 64
    q2, s2 = torch.cat([q, q], 1), torch.cat([s, s], 1)
    qs = q[: 1 << 14].contiguous()
    return {
        "K2": cs.cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=thr), 5),
        "K2_pad": cs.cuda_ms(lambda: topk_dot(qp, s, ns, k, min_keep=thr), 5),
        "K7": cs.cuda_ms(lambda: topk_dot(q, s, ns, k, min_keep=thr, merge="rows"), 5),
        "K7_pad": cs.cuda_ms(lambda: topk_dot(qp, s, ns, k, min_keep=thr, merge="rows"), 5),
        "K6_b1": cs.cuda_ms(lambda: hamming_topk(codes, lsh.codes_t, lsh.ns_valid, lcfg.rerank,
                                                 lcfg.bits, min_keep_sim=keep, mma="b1"), 5),
        "K2_dim256": cs.cuda_ms(lambda: topk_dot(q2, s2, ns, k, min_keep=thr), 5),
        "K2_k64": cs.cuda_ms(lambda: topk_dot(qs, s, ns, 64, min_keep=thr), 5),
        "K7_dim256": cs.cuda_ms(lambda: topk_dot(q2, s2, ns, k, min_keep=thr, merge="rows"), 5),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout to time against this one")
    ap.add_argument("--works", type=int, default=700)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child process's tree
    args = ap.parse_args(argv)
    if args.one is not None:
        tree = args.one.resolve()
        sys.path.insert(0, str(tree))
        print("TREE " + json.dumps(one_tree(tree, args.works)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_topk_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=120, check=True).stdout.strip()
    print(json.dumps({"card": card, **floors(args.works)}), flush=True)
    if args.parent is not None:
        runs = {"parent": [], "this": []}
        for side in ("parent", "this", "this", "parent"):
            tree = args.parent if side == "parent" else ROOT
            r = subprocess.run([sys.executable, __file__, "--one", str(tree), "--works",
                                str(args.works)], capture_output=True, text=True, timeout=900)
            if r.returncode:
                print(r.stdout, r.stderr, file=sys.stderr)
                return r.returncode
            line = [x for x in r.stdout.splitlines() if x.startswith("TREE ")][-1]
            runs[side].append(json.loads(line[5:]))
        print(json.dumps({"card": card, "parent": str(args.parent), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
