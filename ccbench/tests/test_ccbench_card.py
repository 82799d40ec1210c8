"""One short run of each cell on the card through the command line, as the
benchmark is run: one JSON line, ``correct``, and the cell's metrics.
Needs a CUDA device; skips without one."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "-m", "ccbench.run", "--workload", cell, "--seed",
                        "2147483999", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    wanted = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == wanted
