"""The kernels' inputs, for the tests that hold them against their twins
and for ``scripts/kernel_times.py``.

* ``stream_window``, ``near_field_window``: real association windows (K1's
  and K2's inputs) of a facade that host-inserted a synthetic stream;
  ``segment_step``: ground segmentation's inputs of a host-inserted step.
* ``random_window``, ``snake_window``: K2's inputs beyond what streams
  reach, dense random edge words and a snake that needs more rounds than
  the fixpoint's cap, as ``(bits (H+1, 2, R, B) i32, L0 (R, H+B) i32,
  max_wp (1,) i32)`` on the CPU, made from a numpy seed.

No path of the system calls it.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..evaluation.synthetic import frame_to_firings, make_scene, raycast_frame

Window = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _pack(edge: np.ndarray) -> np.ndarray:
    """(..., 64) bool -> (..., 2) i32, bit k of word k // 32 = edge[..., k]."""
    words = np.packbits(edge.reshape(edge.shape[:-1] + (2, 32)), axis=-1, bitorder="little")
    return words.view(np.uint32)[..., 0].view(np.int32)


def random_window(R: int, B: int, H: int = 20, V: int = 20, density: float = 0.002,
                  seed: int = 0) -> Window:
    """Each of the 64 bit positions of every (column offset, batch point) set
    with probability ``density``, those outside the 2V + 1 row offsets and
    those whose neighbour lies outside the window included (both ends
    ignore them); labels a random permutation of the cell ids; ``max_wp``
    = H, so every column offset counts."""
    rng = np.random.default_rng(seed)
    edge = rng.random((H + 1, R, B, 64)) < density
    bits = _pack(edge).transpose(0, 3, 1, 2)
    L0 = rng.permutation(R * (H + B)).astype(np.int32).reshape(R, H + B)
    return (torch.from_numpy(np.ascontiguousarray(bits)), torch.from_numpy(L0),
            torch.tensor([H], dtype=torch.int32))


def snake_window(R: int, B: int, H: int = 20, V: int = 20) -> Window:
    """One chain of diagonal links (dc = 1, dr = +-1) through every batch
    column, zigzagging over the rows: no scan link shortens it, so a label
    travels one cell per round.  The labels are column-major cell ids, the
    smallest at the chain's left end: with B > 65 the fixpoint stops at the
    round cap unconverged."""
    period = 2 * (R - 1)
    row = np.array([min(b % period, period - b % period) for b in range(B)])
    edge = np.zeros((H + 1, R, B, 64), bool)
    for b in range(1, B):
        dr = row[b - 1] - row[b]                  # to (row[b - 1], H + b - 1)
        edge[1, row[b], b, dr + V] = True
    bits = _pack(edge).transpose(0, 3, 1, 2)
    L0 = (np.arange(H + B)[None, :] * R + np.arange(R)[:, None]).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(bits)), torch.from_numpy(L0),
            torch.tensor([1], dtype=torch.int32))


def stream_firings(num_rows: int, num_cols: int, n_rev: int, seed: int = 5,
                   num_boxes: int = 14, spread: float = 30.0) -> List[dict]:
    """Firings of ``n_rev`` revolutions of one synthetic KITTI-like scene,
    each revolution ray-cast with its own seed, 100 ms apart."""
    scene = make_scene(num_boxes=num_boxes, seed=seed, spread=spread)
    firings = []
    for f in range(n_rev):
        xyz, _ = raycast_frame(scene, num_rows=num_rows, num_columns=num_cols, seed=seed + f)
        firings += frame_to_firings(xyz, start_stamp=f * 100_000_000,
                                    end_stamp=(f + 1) * 100_000_000, frame_index=f)
    return firings


def _facade(cfg, num_rows: int, batch: int, device, insertion: str = "host"):
    from ..models.continuous_clustering import ContinuousClustering

    pipe = ContinuousClustering(cfg, firing_batch_size=batch, device=device, insertion=insertion)
    pipe.reset(num_rows)
    pipe.set_transform_robot_frame_from_sensor_frame(np.eye(4))
    return pipe


def stream_window(cfg, num_rows: int, batch: int, firings, stops: Iterable[int],
                  device="cuda"):
    """Of the association windows ``window_arrays`` gathers for the next
    step of a host-insertion facade (firing batch ``batch``) after each of
    ``stops`` of ``firings``, the one with the most active cells."""
    from ..ops.association import window_arrays

    pipe = _facade(cfg, num_rows, batch, device)
    B = pipe._batch_B
    best, fed = None, 0
    for stop in stops:
        for f in firings[fed:stop]:
            pipe.add_firing(f, np.eye(4))
        fed = stop
        state = pipe.state
        win = window_arrays(cfg, state, state.first_unfinished - B,
                            torch.tensor(B, dtype=torch.int32, device=state.device), B)
        if best is None or int(win.active_w.sum()) > int(best.active_w.sum()):
            best = win
    return best


def near_field_window(cfg, num_rows: int, batch: int, device="cuda"):
    """The densest window of the throughput runs' ``near_field`` scene (wide
    wedges, many edges) at 1/4, 3/8, ... of its revolution."""
    from .bench_setup import make_bench_scene

    n_cols = cfg.range_image.num_columns
    firings, _ = make_bench_scene(num_rows, n_cols, "near_field")
    return stream_window(cfg, num_rows, batch, firings,
                         range(n_cols // 4, n_cols, n_cols // 8), device)


def segment_step(cfg, num_rows: int, batch: int, device="cuda"):
    """(state, segment inputs, B, steps run) of the middle step of one
    revolution of ``stream_firings`` host-inserted with firing batch
    ``batch``: the steps before it run through ``pipeline_step_block``, then
    its columns are ingested, ready for ``ground_segment_columns``."""
    from ..models.step import block_segment_inputs, pipeline_step_block
    from ..ops.ingest import ingest_columns
    from ..ops.state import init_state
    from . import bench_setup

    n_cols = cfg.range_image.num_columns
    pipe = _facade(cfg, num_rows, batch, device)
    blocks, segps = bench_setup._insert_revolution(
        pipe, stream_firings(num_rows, n_cols, 1), n_cols)
    B, mid = pipe._batch_B, len(blocks) // 2
    hsg = torch.tensor(bench_setup.HSG, device=device)
    state = init_state(cfg, num_rows, device)
    for blk, segp in zip(blocks[:mid], segps[:mid]):
        state, _ = pipeline_step_block(cfg, state, blk, segp, hsg, B)
    state = ingest_columns(cfg, state, blocks[mid], B)
    return state, block_segment_inputs(blocks[mid], segps[mid], hsg), B, mid
