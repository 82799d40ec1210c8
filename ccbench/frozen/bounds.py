# FROZEN COPY of ``chip_smoke.py::bound`` and ``chip_smoke.py::kernel_bounds``
# (chip_smoke.py:344-388) and their constants (chip_smoke.py:116-124) at
# commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file.  Changed from the original: ``win`` may be any object with
# ``active_w`` and ``wp``, and the torch import is local to the one call
# that needs it.

"""The least time the H100 could take for one launch of K1 (``edge_bits``)
and K2 (``window_cc``), from that launch's own inputs."""

from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM
# rate and the f32 rate outside the tensor cores, the roofline of both
# kernels (neither uses the tensor cores); both assume the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per candidate pair of K1's wedge walk: the inclination
# test (sub, abs, compare), the squared distance (3 sub, 3 mul, 2 add) and
# the radius compare
K1_OPS_PER_PAIR = 12


def bound(nbytes: int, ops: int) -> dict:
    """The larger of ``nbytes`` over the HBM rate and ``ops`` over the f32
    rate, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, ops=ops)


def kernel_bounds(win, bits, max_wp, rounds, H, V):
    """Least time the card could take for each kernel's work on this
    window.  Bytes: each input the kernel reads once, each output written
    once.  K1 reads the window and writes every plane of bits; K2 reads the
    two words of bits for the column offsets it uses, dc < min(max_wp, H) +
    1 (the scans' links, bits[1] and bits[0], among them), and the labels.
    Operations: K1's candidate pairs of this window (active batch points x
    column offsets up to their wedge x 2V + 1 row offsets); K2's per-round
    edge relaxations and scans of this run's rounds (integer min, counted at
    the f32 rate)."""
    R, WCOL = win.active_w.shape
    B = WCOL - H
    f32 = 4
    k1_bytes = (4 * R * WCOL * f32 + R * WCOL * 1 + 2 * R * B * f32
                + bits.numel() * f32)
    active_b = win.active_w[:, H:]
    pairs = int(((win.wp.clamp(max=H) + 1) * active_b).sum()) * (2 * V + 1)
    k1_ops = pairs * K1_OPS_PER_PAIR
    n_edges = int(np.unpackbits(bits.cpu().numpy().view(np.uint8)).sum())
    planes = set(range(2 * (min(int(max_wp), H) + 1)))   # (dc, word) planes
    if H >= 1:
        planes.add(2 + V // 32)
    if V >= 1:
        planes.add((V - 1) // 32)
    k2_bytes = len(planes) * R * B * f32 + 2 * R * WCOL * f32 + 4 + 8
    k2_ops = int(rounds) * (n_edges + 4 * R * WCOL)
    return {"edge_bits": bound(k1_bytes, k1_ops), "window_cc": bound(k2_bytes, k2_ops)}
