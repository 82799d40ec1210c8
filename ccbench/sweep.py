"""The knee of an open-loop cell: its traffic at each of several fixed
column rates, one window each, with the backlog's trend.

    python3 -m ccbench.sweep --workload <name> --seconds 20 --rates 1000,1100,1200

Prints one JSON line per rate: how late ``add_firing`` took the columns of
the window's first and last tenth, the largest lateness, the clusters
published and their p50/p95 latency.  A rate whose lateness grows through
the window is above the knee; the cell runs at 4/5 of the highest rate
whose lateness does not grow.  Needs the card; the benchmark's runs do not
run it.
"""

from __future__ import annotations

import argparse
import importlib
import json

import numpy as np

from .frozen.latency import percentiles
from .harness import import_program, load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 777)
    args = p.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    port = import_program()
    mod = importlib.import_module(f"ccbench.drivers.{cell.traffic['driver']}")
    for rate in (float(r) for r in args.rates.split(",")):
        drv = mod.Driver(port, cell.config, dict(cell.traffic, columns_per_s=rate), args.seed,
                         torch.device("cuda", 0))
        drv.setup()
        w = drv.window(args.seconds)
        lags = np.asarray(w["input_lag_ms"])
        tenth = max(1, len(lags) // 10)
        lat = percentiles(w["latency_ms"])
        print(json.dumps({"columns_per_s": rate, "lag_first_tenth_ms": float(lags[:tenth].mean()),
                          "lag_last_tenth_ms": float(lags[-tenth:].mean()),
                          "lag_max_ms": float(lags.max()), "clusters": len(w["latency_ms"]),
                          "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms")}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
