"""Synthetic association windows that hold the CC kernel (K2) against its
twin beyond what the streamed windows reach: dense random edge words, and a
snake that needs more rounds than the fixpoint's cap.

Each function returns ``(bits (H+1, 2, R, B) i32, L0 (R, H+B) i32, max_wp
(1,) i32)`` on the CPU, made from a numpy seed.

No path of the system calls it.  It sits in the package's tools, beside
``bench_setup``, so that ``chip_smoke.py`` (which imports only the package)
and the tests hold K2 against its twin on the same windows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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
