"""Run one cell of the benchmark once.

    python3 -m ccbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON object, the
last line of standard output, and the numbers compared with their limits as
the last lines of standard error.  Exits non-zero, printing no result,
without a CUDA device (or fewer than the cell asks for), when the program
is missing, or when JAX or the JAX package was loaded.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches of anything the run compiles, at fixed paths inside
# the checkout (the program builds its own into its package's build/)
CACHE = ROOT / ".ccbench_cache"


def process_start() -> float:
    """The process's start on the wall clock (import time where /proc has
    no answer)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return min(btime + ticks / os.sysconf("SC_CLK_TCK"), T_IMPORT)
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    from ccbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ccbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"ccbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"_window": out.pop("_window")}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
