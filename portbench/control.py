"""The control of ``correct``, and the readings its limits are set from.

    python3 -m portbench.control --workload <name> --seeds 11,12,13 \\
        --seconds 10 [--dtype float32]

runs the cell once per seed in one process, as ``run.py`` does (the same
set-up, window and check), with the program computing in ``--dtype``:
float32 is the control, the precision below the configuration's
float64, on the program's own float32 path.  It prints, per seed, each
number compared beside its limit and whether the run came out correct;
the control has to come out not correct on every seed.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)

    import torch

    from portbench.run import resolve, run_cell
    cell = resolve(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card, and there is none",
              file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result, lines = run_cell(cell, seed, args.seconds, False,
                                 dtype=args.dtype)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "dtype": args.dtype, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
