"""The readings that a cell's limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... --seconds 6 \\
        --out calibrate.<name>.jsonl

runs the cell once per seed in one process (a short window at the cell's
own sizes), and for each writes one line: the program's numbers against
the reference (the lower readings) and the control's, the reference
computed in the mix's ``control_dtype`` put in the program's place (the
upper readings). The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark import core

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first N seeds only (default: all)")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
            t = time.time()
            control = a.control_seeds is None or i < a.control_seeds
            r = core.run_cell(a.workload, seed, a.seconds, False, "cuda", t0=t, control=control)
            line = {"workload": a.workload, "seed": seed, "correct": r["correct"],
                    "attempted": r["attempted"], "metrics": r["metrics"],
                    "program": r["numbers"], "control": r.get("control"),
                    "seconds": time.time() - t}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
