"""The two hand-written Hopper kernels of association, their wrappers and
their plain PyTorch twins, and the build of every kernel source of the port
(``csrc/*.cu``; ground segmentation's kernel, ``csrc/ground_segment.cu``,
has its wrapper and twin in ``ops/ground_segmentation.py``).

* K1 ``edge_bits`` (``csrc/edge_bits.cu``) replaces ``edge_bits_pallas``
  (``continuous_clustering_tpu/ops/cc_pallas.py``): wedge neighbour search
  -> forward edge bitmasks (H+1, 2, R, B) i32, bit ``dr + V`` of the two
  words marks an edge from batch point (r, b) to window cell
  (r + dr, H + b - dc).  One thread per (batch point, column offset), the
  window tile staged in shared memory.
* K2 ``window_cc`` (``csrc/window_cc.cu``) replaces ``window_cc_pallas`` +
  ``sweep_pallas``: the whole min-label fixpoint in one cooperative launch
  over every SM, the twin's Jacobi rounds exactly (labels, converged and
  the round count), the labels in global memory (no size limit but the
  card's memory).

Both kernels take S windows of one shape stacked along a leading axis in one
launch (``edge_bits_stacked``, ``window_cc_stacked``; the multi-sensor step
launches each once for all its streams).  ``edge_bits`` and ``window_cc``
are the S = 1 case of the same launch.

The wrapper rule: a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain twin.  The twins are the JAX package's XLA formulations
(``association._edge_bits`` XLA branch, ``_window_cc_vectorized`` with the
shipped scan schedule), one window each; the stacked twins loop them over
the windows.  Each launch is counted in ``utils/stats.LAUNCHES``.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``continuous_clustering_tpu_torch/build/`` (plain C interface, ctypes), one
compiler process per source, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..native import BUILD_DIR, compile_atomic, sources_digest
from ..utils.stats import LAUNCHES, host_bool

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# the fixpoint's round cap (a hit with labels still changing is cc_failed)
MAX_ROUNDS = 64
# windows one K2 launch takes (its change masks are one 32-bit word)
MAX_STACKED_WINDOWS = 32

_KLIB: Optional[ctypes.CDLL] = None


def kernel_library_path() -> Path:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    return BUILD_DIR / f"libcct_kernels-{sources_digest(srcs)}.so"


def _build_kernel_library(out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc] + compile_flags + ["-c", str(src), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(proc.communicate()[0], proc.returncode) for proc in procs]
    try:
        failed = [log for log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("build of the CUDA kernels failed:\n" + "\n".join(failed))
        compile_atomic([nvcc] + NVCC_FLAGS + [str(o) for o in objs], out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load_kernels() -> ctypes.CDLL:
    """Build (once) and load the kernel library."""
    global _KLIB
    if _KLIB is None:
        out = kernel_library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            _build_kernel_library(out)
        lib = ctypes.CDLL(str(out))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cct_edge_bits.restype = ctypes.c_int
        lib.cct_edge_bits.argtypes = [p] * 8 + [i] * 5 + [f, p]
        lib.cct_window_cc.restype = ctypes.c_int
        lib.cct_window_cc.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.cct_sweep_probe.restype = ctypes.c_int
        lib.cct_sweep_probe.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
        lib.cct_ground_segment.restype = ctypes.c_int
        lib.cct_ground_segment.argtypes = [p] * 3 + [i] * 3 + [p]
        _KLIB = lib
    return _KLIB


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: edge bits
# ---------------------------------------------------------------------------


def edge_bits(xw, yw, zw, incw, active_w, mad, wp, *, H: int, V: int,
              max_d2: float) -> torch.Tensor:
    """Forward edge bitmasks (H+1, 2, R, B) i32 of the window.

    xw, yw, zw, incw (R, H+B) f32; active_w (R, H+B) bool; mad (R, B) f32;
    wp (R, B) i32.  ``max_d2`` is the f32 square of the clustering radius."""
    args = (xw, yw, zw, incw, active_w, mad, wp)
    return edge_bits_stacked(*(a[None] for a in args), H=H, V=V, max_d2=max_d2)[0]


def edge_bits_stacked(xw, yw, zw, incw, active_w, mad, wp, *, H: int, V: int,
                      max_d2: float) -> torch.Tensor:
    """``edge_bits`` of S windows in one launch: (S, R, H+B) windows and
    (S, R, B) ``mad``/``wp`` -> (S, H+1, 2, R, B) bits."""
    if xw.device.type == "cpu":
        return torch.stack([edge_bits_reference(*win, H=H, V=V, max_d2=max_d2)
                            for win in zip(xw, yw, zw, incw, active_w, mad, wp)])
    if xw.device.type != "cuda":
        raise ValueError(f"edge_bits: unsupported device {xw.device}")
    S, R, WCOL = xw.shape
    B = WCOL - H
    if 2 * V + 1 > 64:
        raise ValueError("edge_bits packs 2V+1 row offsets into two words: V <= 31")
    if S < 1:
        raise ValueError("edge_bits: no window")
    dev = xw.device
    for name, t in (("xw", xw), ("yw", yw), ("zw", zw), ("incw", incw)):
        check_tensor(t, name, torch.float32, (S, R, WCOL), dev)
    check_tensor(active_w, "active_w", torch.bool, (S, R, WCOL), dev)
    check_tensor(mad, "mad", torch.float32, (S, R, B), dev)
    check_tensor(wp, "wp", torch.int32, (S, R, B), dev)
    bits = torch.empty((S, H + 1, 2, R, B), dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cct_edge_bits(
            xw.data_ptr(), yw.data_ptr(), zw.data_ptr(), incw.data_ptr(),
            active_w.data_ptr(), mad.data_ptr(), wp.data_ptr(), bits.data_ptr(),
            S, R, B, H, V, max_d2, stream)
    raise_on_error(err, "edge_bits")
    LAUNCHES["edge_bits"] += 1
    return bits


def _pack_words(edge: torch.Tensor) -> torch.Tensor:
    """(n_dr, ...) bool -> (2, ...) i32 with bit k of word k // 32 = edge[k]."""
    n_dr = edge.shape[0]
    weights = torch.tensor([1 << (k % 32) for k in range(n_dr)], dtype=torch.int64,
                           device=edge.device).reshape((n_dr,) + (1,) * (edge.dim() - 1))
    e = edge.to(torch.int64) * weights
    words = torch.stack([e[:32].sum(0), e[32:].sum(0)])
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def edge_bits_reference(xw, yw, zw, incw, active_w, mad, wp, *, H: int, V: int,
                        max_d2: float) -> torch.Tensor:
    """Plain PyTorch twin of K1 (the JAX package's XLA formulation, one
    column offset at a time)."""
    R, WCOL = xw.shape
    B = WCOL - H
    n_dr = 2 * V + 1
    dev = xw.device

    def vpad(a, fill):
        pad = torch.full((V, WCOL), fill, dtype=a.dtype, device=dev)
        return torch.cat([pad, a, pad], dim=0)

    nan = float("nan")
    xp, yp, zp, ip = vpad(xw, nan), vpad(yw, nan), vpad(zw, nan), vpad(incw, nan)
    ap = vpad(active_w, False)
    xb, yb, zb, incb = xw[:, H:], yw[:, H:], zw[:, H:], incw[:, H:]
    active_b = active_w[:, H:]
    bits = torch.zeros((H + 1, 2, R, B), dtype=torch.int32, device=dev)
    for dc in range(H + 1):
        def g(a):  # neighbours (r + dr, H + b - dc) for all dr: (n_dr, R, B)
            return torch.stack([a[k:k + R, H - dc:H - dc + B] for k in range(n_dr)])

        nx, ny, nz, ninc, nact = g(xp), g(yp), g(zp), g(ip), g(ap)
        # NaN never breaks the walk: the reference breaks on |diff| > mad
        incl_ok = ~(torch.abs(ninc - incb[None]) > mad[None])
        ok0 = incl_ok[V]
        up = torch.flip(torch.cumprod(torch.flip(incl_ok[:V], [0]).to(torch.int32), 0), [0]).bool()
        down = torch.cumprod(incl_ok[V + 1:].to(torch.int32), 0).bool()
        if dc == 0:  # same column: the up walk starts at dr = -1, no down walk
            reach = torch.cat([up, torch.zeros_like(down[:1]), torch.zeros_like(down)])
        else:
            reach = torch.cat([up & ok0[None], ok0[None], down])
        dx, dy, dz = nx - xb[None], ny - yb[None], nz - zb[None]
        close = (dx * dx + dy * dy + dz * dz) < max_d2
        edge = reach & close & nact & active_b[None] & (dc <= wp)[None]
        bits[dc] = _pack_words(edge)
    return bits


# ---------------------------------------------------------------------------
# K2: window connected components
# ---------------------------------------------------------------------------


def window_cc(bits, L0, max_wp, *, H: int, V: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-label fixpoint over the window graph of ``bits``, seeded by
    ``L0`` (R, H+B) i32; ``max_wp`` (1,) i32 bounds the column offsets.
    Returns (labels (R, H+B) i32, converged () bool, rounds () i32)."""
    labels, converged, rounds = window_cc_stacked(bits[None], L0[None], max_wp, H=H, V=V)
    return labels[0], converged[0], rounds[0]


def window_cc_stacked(bits, L0, max_wp, *, H: int, V: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``window_cc`` of S windows in one launch: (S, H+1, 2, R, B) bits,
    (S, R, H+B) ``L0`` and (S,) ``max_wp`` -> labels (S, R, H+B) i32,
    converged (S,) bool and rounds (S,) i32, each window's own (a window
    that has converged takes no further rounds).  Nothing is read back to
    the host."""
    if L0.device.type == "cpu":
        outs = [window_cc_reference(b, l0, m, H=H, V=V)
                for b, l0, m in zip(bits, L0, max_wp.reshape(-1, 1))]
        return tuple(torch.stack(xs) for xs in zip(*outs))
    if L0.device.type != "cuda":
        raise ValueError(f"window_cc: unsupported device {L0.device}")
    S, R, WCOL = L0.shape
    B = WCOL - H
    if not 1 <= S <= MAX_STACKED_WINDOWS:
        raise ValueError(f"window_cc takes 1 to {MAX_STACKED_WINDOWS} windows, got {S}")
    dev = L0.device
    check_tensor(bits, "bits", torch.int32, (S, H + 1, 2, R, B), dev)
    check_tensor(L0, "L0", torch.int32, (S, R, WCOL), dev)
    check_tensor(max_wp, "max_wp", torch.int32, (S,), dev)
    # one allocation: the labels, the previous round's labels, and the flags
    # (converged and rounds per window, the kernel's change words per window
    # and round parity); converged is read as a bool view of its words'
    # first bytes, so no further kernel runs
    n = S * R * WCOL
    buf = torch.empty((2 * n + 4 * S,), dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cct_window_cc(bits.data_ptr(), L0.data_ptr(), max_wp.data_ptr(),
                                ptr, ptr + 4 * n, ptr + 8 * n, S, R, B, H, V, MAX_ROUNDS, stream)
    raise_on_error(err, "window_cc")
    LAUNCHES["window_cc"] += 1
    flags = buf[2 * n:]
    return buf[:n].view(S, R, WCOL), flags[:S].view(torch.bool)[::4], flags[S:2 * S]


def _seg_min_scan(L: torch.Tensor, start: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive segmented min along ``dim`` (a segment starts where
    ``start`` holds) by log-step doubling; exact on i32."""
    v, f = L, start
    n, s = L.shape[dim], 1
    while s < n:
        vp, fp = v.narrow(dim, 0, n - s), f.narrow(dim, 0, n - s)
        vc, fc = v.narrow(dim, s, n - s), f.narrow(dim, s, n - s)
        v = torch.cat([v.narrow(dim, 0, s), torch.where(fc, vc, torch.minimum(vp, vc))], dim)
        f = torch.cat([f.narrow(dim, 0, s), fc | fp], dim)
        s *= 2
    return v


def _scan_min(L: torch.Tensor, conn: torch.Tensor, dim: int) -> torch.Tensor:
    """Propagate the minimum through runs of cells linked by ``conn``
    (conn[i] links i-1 and i along ``dim``), both directions."""
    fwd = _seg_min_scan(L, ~conn, dim)
    start_b = ~torch.roll(conn, -1, dims=dim)
    bwd = torch.flip(_seg_min_scan(torch.flip(L, [dim]), torch.flip(start_b, [dim]), dim), [dim])
    return torch.minimum(fwd, bwd)


def _pad2(a: torch.Tensor, V: int, H: int, value) -> torch.Tensor:
    """Pad the last two dims by V rows and H columns on each side."""
    out = a.new_full(a.shape[:-2] + (a.shape[-2] + 2 * V, a.shape[-1] + 2 * H), value)
    out[..., V:V + a.shape[-2], H:H + a.shape[-1]] = a
    return out


def _bit(word: torch.Tensor, k: int) -> torch.Tensor:
    return ((word >> k) & 1) == 1


def window_cc_reference(bits, L0, max_wp, *, H: int, V: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K2: Jacobi min-label rounds over all offsets,
    then the segmented row scan (from round 0) and column scan (from round
    1), until a round changes nothing or ``MAX_ROUNDS`` rounds ran."""
    del max_wp  # offsets beyond the widest wedge carry no bits
    R, WCOL = L0.shape
    n_dr, ND = 2 * V + 1, H + 1
    dev = L0.device
    inf = R * WCOL
    k = torch.arange(n_dr, device=dev)
    word = bits[:, k // 32]                                     # (ND, n_dr, R, B)
    m = ((word >> (k % 32)[None, :, None, None]) & 1) == 1
    maskL = torch.cat([torch.zeros((ND, n_dr, R, H), dtype=torch.bool, device=dev), m], dim=3)
    # reverse masks at the source position (r - dr, wc + dc)
    mp = _pad2(maskL, V, H, False)
    maskR = torch.stack([
        torch.stack([mp[dc, j, 2 * V - j:2 * V - j + R, H + dc:H + dc + WCOL]
                     for j in range(n_dr)])
        for dc in range(ND)])

    def sweep(L):
        Lpad = _pad2(L, V, H, inf)
        rows = torch.stack([Lpad[j:j + R] for j in range(n_dr)])  # (n_dr, R, PW)
        rows_f = torch.flip(rows, [0])
        out = L
        for dc in range(ND):
            nb = rows[:, :, H - dc:H - dc + WCOL]
            out = torch.minimum(out, torch.where(maskL[dc], nb, inf).amin(0))
            src = rows_f[:, :, H + dc:H + dc + WCOL]
            out = torch.minimum(out, torch.where(maskR[dc], src, inf).amin(0))
        return out

    zeros_h = torch.zeros((R, H), dtype=torch.bool, device=dev)
    hconn = vconn = None
    if H >= 1:  # (dr = 0, dc = 1) links
        hconn = torch.cat([zeros_h, _bit(bits[1, V // 32], V % 32)], dim=1)
    if V >= 1:  # (dr = -1, dc = 0) links; row 0 never links upward
        vb = _bit(bits[0, (V - 1) // 32], (V - 1) % 32).clone()
        vb[0] = False
        vconn = torch.cat([zeros_h, vb], dim=1)

    L, changed, it = L0, True, 0
    while changed and it < MAX_ROUNDS:
        L2 = sweep(L)
        if hconn is not None:
            L2 = _scan_min(L2, hconn, 1)
        if vconn is not None and it >= 1:
            L2 = _scan_min(L2, vconn, 0)
        changed, it = host_bool((L2 != L).any()), it + 1
        L = L2
    return (L, torch.tensor(not changed, device=dev),
            torch.tensor(it, dtype=torch.int32, device=dev))
