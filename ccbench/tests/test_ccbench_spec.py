"""``BENCHMARK.json`` against the benchmark's files: every cell resolves
its configuration, traffic, limits and metric readers by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from ccbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell, SPEC)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert c.limits and all(v >= 0 for v in c.limits.values())
    moved = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in moved for m in c.per_layer)


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("ccbench/")
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}


def test_every_metric_file_is_named_in_the_spec():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == names
