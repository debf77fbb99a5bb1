"""The readings that set a cell's limits, several seeds in one process on
the card:

    python3 kvbench/control.py --workload <name> --seeds 11,12,13 --seconds <run_seconds>

For each seed it runs the cell as ``kvbench/run.py`` does (``--trace 0``)
and reads each compared number twice after the window: the program's (the
lower reading) and the control's, the plain reference in TF32 put in the
program's place (the upper reading).  The control's numbers decide the
run's ``correct``, which has to read false; the program's verdict is
``program_correct``.  One JSON line per seed, then a summary.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])   # the checkout, not kvbench/
from kvbench import run  # noqa: E402  (sets the paths and cache directories)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False, control=True,
                           t_start=time.perf_counter(), emit=lambda line: None)
        c = out["checks"]
        row = {"seed": seed, "correct": out["correct"], "program_correct": out["program_correct"],
               "checks": {k: v["value"] for k, v in c.items()},
               "metrics": out["metrics"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    pairs = {"logit_error": "control_error", "selection_slack": "control_slack",
             "routing_slack": "control_routing_slack"}
    print(json.dumps({"workload": args.workload,
                      "control_not_correct": all(not r["correct"] for r in rows),
                      "program_correct": all(r["program_correct"] for r in rows), **{
        num: {"lower": max(r["checks"][num] for r in rows),
              "upper": min(r["checks"][ctl] for r in rows)} for num, ctl in pairs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
