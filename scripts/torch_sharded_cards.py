#!/usr/bin/env python3
"""The sharded engine on every card of one machine, beside one card.

    python3 scripts/torch_sharded_cards.py [--works 2000] [--seed 0]

Run from the root of a checkout on a machine with four or more NVIDIA
GPUs (with fewer, the grids name the cards in turn, as ``chip_smoke.py``
does).  It builds the kernels, makes ``chip_smoke.py``'s world at
``--works`` works, searches it on one card (``end_to_end``: sample parity
against the NumPy oracle), then times in turns one card, the 2 x 2 mesh
over four cards, the mesh again and one card again, each a warm
``search_works`` with its stage seconds; then runs ``chip_smoke.py``'s
``sharded`` and ``sharded dryrun`` phases (every kernel call of the
first batch's sharded step held to its plain version, rows equal to one
card's and to the oracle's).  The card's name and power limit come first.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--works", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as C
    from fandom_search_tpu_torch.config import MeshConfig
    from fandom_search_tpu_torch.ops import _cuda
    from fandom_search_tpu_torch.parallel.mesh import make_mesh
    from fandom_search_tpu_torch.parallel.sharded import ShardedSearchEngine
    from fandom_search_tpu_torch.search.engine import SearchEngine

    if not torch.cuda.is_available():
        print("torch_sharded_cards: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(f"cards: {torch.cuda.device_count()}; nvcc {_cuda.build(force=True):.1f}s",
          flush=True)
    cfg, index, works, planted, _ = C.make_world(args.seed, args.works)
    one = SearchEngine(index, cfg, device="cuda")
    rows, _, secs, oracle = C.end_to_end(one, works, planted, index, cfg, sample=20)
    devices, which = C.mesh_devices(4)
    mcfg = dataclasses.replace(cfg, mesh=MeshConfig(works=2, script=2))
    mesh = ShardedSearchEngine(index, mcfg, mesh=make_mesh(mcfg.mesh, devices))
    turns = []
    for name, eng in (("one card", one), ("mesh 2x2", mesh), ("mesh 2x2", mesh),
                      ("one card", one)):
        got, stats, s = C.search(eng, works)
        C.check(C._csv_rows(got) == C._csv_rows(rows), f"{name}: rows differ from one card's")
        turns.append({"engine": name, "seconds": s, "stage_seconds": stats.extra})
    print(json.dumps({"in_turns": turns, "mesh_devices": which, "works": len(works)}),
          flush=True)
    C.sharded_end_to_end(index, cfg, works, planted, rows, oracle, secs)
    C.sharded_dryrun()
    return 0


if __name__ == "__main__":
    sys.exit(main())
