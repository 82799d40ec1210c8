"""The control of ``correct``: the reference with every point's
coordinates held in bfloat16 (one step below the configuration's float32)
put in the program's place, compared with the reference as a run's
answers are.  It has to come out not correct.

    python3 -m ccbench.control --workload <name> --seeds 1,2,3

Prints one JSON line per seed with the numbers compared and whether the
cell's limits pass them.  Runs on the CPU; the benchmark's runs do not
run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

from .check import compare, judge, steady_as_output
from .harness import load_cell
from .reference.steady import steady_revolution


def control(cell, seed: int) -> dict:
    drv = importlib.import_module(f"ccbench.drivers.{cell.traffic['driver']}").Driver(
        None, cell.config, cell.traffic, seed % (1 << 64), None)
    rows = cell.config["sensor"]["rows"]
    t0 = time.time()
    ref = steady_revolution(cell.config["pipeline"], rows, drv.reference_firing, drv.ego)
    t1 = time.time()
    low = steady_revolution(cell.config["pipeline"], rows, drv.reference_firing, drv.ego,
                            bfloat16_points=True)
    clusters, cols = steady_as_output(low)
    res = compare(ref, clusters, cols, [1], drv.rev_ns, drv.uidx_per_rev)
    return {"workload": cell.name, "seed": seed, "numbers": res["numbers"],
            "correct": judge(res["numbers"], cell.limits), "reference_s": t1 - t0,
            "clusters": len(ref.clusters), "control_clusters": len(low.clusters)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control(cell, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
