"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit).  Everything else goes to standard
error, ending with the compared numbers.  Exits 2 without a result when
CUDA is missing or has fewer cards than the cell asks for, and 3 when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The program builds its kernels into fandom_search_tpu_torch/build/
# inside the checkout (a fixed path), so only a checkout's first run
# builds; it uses neither Triton nor torch's extension builder.
ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cells
    from benchmark.harness.imports import ForbiddenImport, forbidden_modules

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    from benchmark.harness import runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START)
    except ForbiddenImport as e:
        print(f"forbidden import: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"forbidden import: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
