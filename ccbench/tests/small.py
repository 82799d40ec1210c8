"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: 32 rows
and 220 columns, every other setting as the cell has it."""

from __future__ import annotations

import copy
import time

import torch

from ccbench import harness

ROWS, COLUMNS = 32, 220
SEED = 2**31 + 4242
# a few threads a test process, so that parallel test workers share the cores
torch.set_num_threads(2)


def small_cell(name: str, **traffic) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["sensor"]["rows"], cfg["sensor"]["columns"] = ROWS, COLUMNS
    cfg["pipeline"]["range_image"]["num_columns"] = COLUMNS
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def run_small(name: str, seconds: float = 2.0, seed: int = SEED, **traffic):
    return harness.run_cell(small_cell(name, **traffic), seed, seconds, False,
                            torch.device("cpu"), time.time())
