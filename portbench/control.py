"""The control of the benchmark's check: the plain reference put in the
program's place, computed in the next precision below the one the
configuration states, and held to the reference by the same comparison
a run makes (`control(cell, recipe, seed)` of the reference that the
configuration names).

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

For each seed it prints one line: the queries compared and the
mismatched ones.  A control has to come out mismatched on every seed;
the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def main(argv=None) -> int:
    from portbench.run import load_cell

    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cfg = cell["config"]
    recipe = importlib.import_module(f"portbench.recipes.{cfg['recipe']}")
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    for s in args.seeds:
        print(json.dumps({"control": args.workload, "seed": s,
                          **ref.control(cell, recipe, s)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
