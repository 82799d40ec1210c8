"""Device times of the port's hand-written CUDA kernels at the main path's
shapes, each beside the least time the card could take for its work.

    python3 scripts/kernel_times.py

Needs a CUDA device.  Times, on inputs of ``tools/cc_windows.py``, K1 and K2
on the KITTI configuration's windows (64 x 2200, batch 384: a KITTI-like
stream and the densest ``near_field`` window) alone and stacked in one
launch (K2 with the round-cap snake as a third window); the probe variants
at upper = 21; ground segmentation on a host-inserted step of the KITTI
configuration (64 x 416) and of the VLS-128 roof preset (128 x 288).  Each
time is a CUDA-event median of 20 launches: ``device_ms`` with the card put
to sleep first, so the launch is enqueued before the start event runs;
``ms`` with the host's enqueue; ``plain_ms``, a median of 5, the plain
PyTorch twin on the card (none for the stacked launches).  Bounds at 3.35
TB/s and 67 TFLOP/s f32 (one H100 SXM at 700 W): K1's and K2's from
``ccbench/frozen/bounds.py``, the benchmark's rooflines; the others below.
Prints the card and its power limit, then one JSON line per kernel and
input (``share_pct``: the bound over ``device_ms``).  ``chip_smoke.py``
calls ``measure``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccbench.frozen.bounds import bound, kernel_bounds  # noqa: E402

# device cycles the card sleeps before a timed launch (about 1 ms on the
# H100), so that the start event runs after the launch is enqueued
SLEEP_CYCLES = 2_000_000
# integer operations per cell and step of a probe variant (lane index,
# mask, select, min)
PROBE_OPS_PER_CELL_STEP = 4


def median_ms(fn, n: int = 20, warmup: int = 3, device_only: bool = False) -> float:
    """Median of ``n`` CUDA-event times of ``fn``; with ``device_only`` the
    card sleeps first, so the host's enqueue is not in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def report(kernel: str, inputs: str, fn, b: dict, card: dict, plain=None) -> dict:
    """Time ``fn`` (and its twin ``plain``), print the JSON line, return it."""
    device_ms = median_ms(fn, device_only=True)
    rec = {"kernel": kernel, "inputs": inputs, "device_ms": device_ms, "ms": median_ms(fn),
           "plain_ms": median_ms(plain, n=5, warmup=1) if plain else None, **b,
           "share_pct": 100 * b["bound_ms"] / device_ms, **card}
    print(json.dumps(rec), flush=True)
    return rec


def probe_bound(name: str, L, upper: int) -> dict:
    """One launch of probe variant ``name``.  Bytes: the labels in and out,
    and for V3, V3i and V4 word 0 of bits[dc] for dc < upper (no variant
    reads word 1, the others no bits).  Operations: one step per cell for
    V0 and V1, ``upper`` for V2, 3 x ``upper`` for V3, V3i, V4 and V5 (three
    bands), three compares for V6."""
    from continuous_clustering_tpu_torch.ops.sweep_probe import B, R

    reads_bits = name in ("V3_bool_mask", "V3i_i32_mask", "V4_mask_scratch")
    steps = {"V0_init_copy": 1, "V1_static_slice_roll": 1, "V2_dynamic_roll": upper,
             "V6_bitpack": 3}.get(name, 3 * upper)
    nbytes = (upper * R * B * 4 if reads_bits else 0) + 2 * L.numel() * 4
    return bound(nbytes, steps * L.numel() * PROBE_OPS_PER_CELL_STEP)


def ground_segment_bound(state, seg_in, B: int, fog: bool) -> dict:
    """One segmentation step: each ring cell of the segmented columns read
    once (x, y, z, distance, inclination, gcol, and intensity with fog
    filtering) and written once (both labels, is_ignored, inclination, gcol,
    and cont_az of the NaN cells), the per-column poses (15 f32) and the
    inclination carry in and out.  No operation bound: a few tens of f32
    operations a cell are below the bytes' time."""
    from continuous_clustering_tpu_torch.ops.state import ring_read

    R, n = state.num_rows, int(seg_in.n_cols)
    dist = ring_read(state.distance, seg_in.gcol0 % state.ring_cols, B)[:, :n]
    nbytes = R * n * (6 * 4 + 4 * fog + 2 * 4 + 1 + 2 * 4) + int(torch.isnan(dist).sum()) * 4
    return bound(nbytes + B * 15 * 4 + 2 * R * 4, 0)


def summed(bounds) -> dict:
    return bound(sum(b["bytes"] for b in bounds), sum(b["ops"] for b in bounds))


def card_name() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (x.strip() for x in smi.splitlines()[0].split(","))
    return {"card": name, "power_limit": limit}


def measure(card: dict) -> list:
    """Time every kernel on every input; the records, in the printed order."""
    from continuous_clustering_tpu_torch.config import kitti_config, vls128_roof_config
    from continuous_clustering_tpu_torch.ops import cc_cuda, sweep_probe
    from continuous_clustering_tpu_torch.ops.ground_segmentation import (
        ground_segment_columns, ground_segment_columns_reference)
    from continuous_clustering_tpu_torch.ops.state import copy_state
    from continuous_clustering_tpu_torch.tools import cc_windows
    from continuous_clustering_tpu_torch.tools.sweep_probe import probe_inputs

    dev, out = torch.device("cuda", 0), []

    cfg = kitti_config()
    cl = cfg.clustering
    H, V = cl.max_steps_in_row, cl.max_steps_in_column
    rows, batch, n_cols = 64, 384, cfg.range_image.num_columns
    windows = {
        "kitti": cc_windows.stream_window(cfg, rows, batch, cc_windows.stream_firings(
            rows, n_cols, 2), [3 * n_cols // 2], dev),
        "near_field": cc_windows.near_field_window(cfg, rows, batch, dev),
    }
    md = np.float32(cl.max_distance)
    k1_kw = dict(H=H, V=V, max_d2=float(md * md))
    fields = ("xw", "yw", "zw", "incw", "active_w", "mad", "wp")
    k2_inputs, k1_bounds, k2_bounds = {}, [], []
    for wname, win in windows.items():
        args = [getattr(win, f) for f in fields]
        bits = cc_cuda.edge_bits(*args, **k1_kw)
        max_wp = torch.where(win.active_w[:, H:], win.wp, 0).max().reshape(1).to(torch.int32)
        _, _, rounds = cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V)
        b = kernel_bounds(win, bits, max_wp, rounds, H, V)
        k1_bounds.append(b["edge_bits"])
        k2_bounds.append(b["window_cc"])
        k2_inputs[wname] = (bits, win.L0, max_wp)
        shape = f"{wname} R={rows} WCOL={win.active_w.shape[1]}"
        out.append(report("edge_bits", shape, lambda: cc_cuda.edge_bits(*args, **k1_kw),
                          b["edge_bits"], card,
                          lambda: cc_cuda.edge_bits_reference(*args, **k1_kw)))
        out.append(report("window_cc", f"{shape}, {int(rounds)} rounds",
                          lambda: cc_cuda.window_cc(bits, win.L0, max_wp, H=H, V=V),
                          b["window_cc"], card,
                          lambda: cc_cuda.window_cc_reference(bits, win.L0, max_wp, H=H, V=V)))
    sargs = [torch.stack([getattr(w, f) for w in windows.values()]) for f in fields]
    out.append(report("edge_bits", "kitti + near_field stacked, one launch",
                      lambda: cc_cuda.edge_bits_stacked(*sargs, **k1_kw), summed(k1_bounds),
                      card))
    snake = [a.to(dev) for a in cc_windows.snake_window(rows, batch + 32, H, V)]
    k2_inputs["snake"] = snake
    # the snake has the KITTI window's shape; only K2's part of the bound is read
    k2_bounds.append(kernel_bounds(windows["kitti"], snake[0], snake[2], cc_cuda.MAX_ROUNDS,
                                   H, V)["window_cc"])
    k2_args = [torch.stack([x[0] for x in k2_inputs.values()]),
               torch.stack([x[1] for x in k2_inputs.values()]),
               torch.cat([x[2] for x in k2_inputs.values()])]
    out.append(report("window_cc", "kitti + near_field + snake stacked, one launch",
                      lambda: cc_cuda.window_cc_stacked(*k2_args, H=H, V=V), summed(k2_bounds),
                      card))

    pbits, pL = (torch.from_numpy(a).to(dev) for a in probe_inputs(0))
    upper = torch.tensor(H + 1, dtype=torch.int32, device=dev)
    for vname in sweep_probe.VARIANTS:
        out.append(report("sweep_probe", f"{vname} upper={H + 1}",
                          lambda: sweep_probe.sweep_probe(vname, pbits, upper, pL),
                          probe_bound(vname, pL, H + 1), card,
                          lambda: sweep_probe.sweep_probe_reference(vname, pbits, upper, pL)))

    for gname, gcfg, grows, gbatch in (("kitti", cfg, 64, 384),
                                       ("vls128_roof", vls128_roof_config(), 128, 256)):
        state, seg_in, B, _ = cc_windows.segment_step(gcfg, grows, gbatch, dev)
        scratch = copy_state(state)
        out.append(report("ground_segment", f"{gname} {grows} x {B}, n_cols {int(seg_in.n_cols)}",
                          lambda: ground_segment_columns(gcfg, scratch, seg_in, B),
                          ground_segment_bound(state, seg_in, B,
                                               gcfg.ground_segmentation.fog_filtering_enabled),
                          card,
                          lambda: ground_segment_columns_reference(gcfg, scratch, seg_in, B)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this script times the kernels on a GPU",
              file=sys.stderr)
        return 2
    card = card_name()
    print(f"{card['card']}, {card['power_limit']}", flush=True)
    measure(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
