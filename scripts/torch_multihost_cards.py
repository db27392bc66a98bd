#!/usr/bin/env python3
"""The sharded engine over four NCCL ranks, one card each, beside one card.

    python3 scripts/torch_multihost_cards.py [--works 2000] [--seed 0] [--ranks 4]

Run from the root of a checkout on a machine with ``--ranks`` NVIDIA
GPUs.  It builds the kernels once, makes ``chip_smoke.py``'s world at
``--works`` works and searches it on one card (``end_to_end``: sample
parity against the NumPy oracle).  Then it starts one rank a card
(``CUDA_VISIBLE_DEVICES`` set to the rank's card; tcp://127.0.0.1 on a
free port, NCCL over the loopback interface), each running the same
world: at mesh 4 x 1 and 2 x 2 over the world's global grid, a first
step with every kernel call held to its plain version
(``chip_smoke.sharded_step_vs_plain``), then warm searches timed in
turns (4 x 1, 2 x 2, 2 x 2, 4 x 1), each ended by a barrier; every rank's
rows must equal one card's.  One card is timed again after the world
has left.  The card's name and power limit come first, then one JSON
line of every rank's times beside one card's.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((4, 1), (2, 2))


def _digest(rows) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def rank_main(args) -> int:
    """One rank: join the world, hold the first step of each mesh to
    plain, time warm searches in turns, write the results."""
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.parallel import mesh as M
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine

    cfg, index, works, _, _ = C.make_world(args.seed, args.works)
    n = M.initialize_multihost(f"127.0.0.1:{args.port}", args.ranks, args.rank,
                               device="cuda", timeout_s=600)
    try:
        engines, held = {}, {}
        for w, s in MESHES:
            mcfg = dataclasses.replace(cfg, mesh=MeshConfig(works=w, script=s))
            engines[(w, s)] = ShardedSearchEngine(index, mcfg)
            held[f"{w}x{s}"] = C.sharded_step_vs_plain(engines[(w, s)], works)
        turns, digests = [], {}
        for w, s in (*MESHES, *reversed(MESHES)):
            dist.barrier()
            rows, stats, secs = C.search(engines[(w, s)], works)
            dist.barrier()
            digests.setdefault(f"{w}x{s}", set()).add(_digest(C._csv_rows(rows)))
            turns.append({"mesh": f"{w}x{s}", "seconds": secs, "stage_seconds": stats.extra,
                          "batches": stats.num_batches, "rows": len(rows)})
        res = {"rank": args.rank, "global_devices": n, "card": torch.cuda.get_device_name(0),
               "in_turns": turns, "digests": {k: sorted(v) for k, v in digests.items()},
               "held_to_plain": held}
        (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(res))
    finally:
        M.shutdown_multihost()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--works", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.rank is not None:
        return rank_main(args)
    import torch

    import chip_smoke as C
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.search.engine import SearchEngine

    if torch.cuda.device_count() < args.ranks:
        print(f"torch_multihost_cards: {args.ranks} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(f"cards: {torch.cuda.device_count()}; nvcc {_cuda.build(force=True):.1f}s",
          flush=True)
    cfg, index, works, planted, _ = C.make_world(args.seed, args.works)
    one = SearchEngine(index, cfg, device="cuda")
    rows, _, first_s, _ = C.end_to_end(one, works, planted, index, cfg, sample=20)
    want = _digest(C._csv_rows(rows))
    one_turns = [C.search(one, works)[2]]
    port = C.free_port()
    env = {**os.environ, "NCCL_SOCKET_IFNAME": "lo"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="multihost_cards_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--works", str(args.works), "--seed", str(args.seed),
             "--ranks", str(args.ranks), "--rank", str(r), "--port", str(port),
             "--out", tmp],
            env={**env, "CUDA_VISIBLE_DEVICES": str(r)}) for r in range(args.ranks)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
        world_s = time.perf_counter() - t0
        C.check(rcs == [0] * args.ranks, f"rank exit codes {rcs}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(args.ranks)]
    one_turns.append(C.search(one, works)[2])
    for res in ranks:
        for mesh, ds in res["digests"].items():
            C.check(ds == [want], f"rank {res['rank']} mesh {mesh}: rows differ from one card's")
    print(json.dumps({
        "works": len(works), "rows": len(rows), "one_card_seconds": one_turns,
        "one_card_first_seconds": first_s, "world_wall_seconds": world_s,
        "cards": [r["card"] for r in ranks], "global_devices": ranks[0]["global_devices"],
        "in_turns": {r["rank"]: r["in_turns"] for r in ranks},
    }), flush=True)
    print("torch_multihost_cards: every rank's rows equal one card's at meshes "
          + ", ".join(f"{w}x{s}" for w, s in MESHES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
