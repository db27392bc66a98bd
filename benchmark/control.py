"""The control of the comparison that decides ``correct``, at a cell's
own size: the plain reference computed in bfloat16 (the nearest
precision below the float32 of the candidate and alignment scores) put
in the program's place, judged by the harness's own comparison
(``runner.control``).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it prints the control's checks and its ``correct``, which
has to come out false; a sound run reads ``rows_missing`` and
``rows_extra`` as 0.  The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark.harness import runner

    for s in args.seeds.split(","):
        r = runner.control(args.workload, int(s), device=args.device)
        print(json.dumps({"seed": int(s), **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
