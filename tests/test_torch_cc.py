"""The port's association window and the plain twins of both kernels
against the JAX package, on real windows.

A window is the input of association at a mid-stream step (in the second
revolution) of a raycast scene and of the serpentine stream.
The plain edge bits are held against the JAX XLA branch and against
``edge_bits_pallas`` in interpret mode; the plain window CC against
``_window_cc_vectorized`` (labels, converged, rounds: the same Jacobi
schedule) and against ``window_cc_pallas`` in interpret mode (labels and
converged; its Gauss-Seidel rounds differ).

Tolerance: bits, labels, masks and flags exact; ``mad`` within 2 ulp
(XLA's f32 arcsin, association.py:335).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from continuous_clustering_tpu.ops import association as jassoc
from continuous_clustering_tpu.ops.cc_pallas import edge_bits_pallas, window_cc_pallas
from continuous_clustering_tpu_torch.convert import config_from_dataclass, state_from_numpy
from continuous_clustering_tpu_torch.ops import cc_cuda
from continuous_clustering_tpu_torch.ops.association import window_arrays
from continuous_clustering_tpu_torch.tools import cc_windows
from continuous_clustering_tpu_torch.utils import stats

from .test_torch_step import (jax_pre_association, jax_state_numpy,  # noqa: F401
                              one_torch_thread, scene_frames, serpentine_frames,
                              small_cfg, ulp_diff)

B = 48


@pytest.fixture(scope="module", params=["scene", "serpentine"])
def window(request):
    cfg = small_cfg()
    frames = (scene_frames(32, 220, 2, num_boxes=12) if request.param == "scene"
              else serpentine_frames(32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CCT_PALLAS", "0")
        js, blk = jax_pre_association(cfg, frames, B, k=6)
        j = jassoc._edge_bits(cfg, js, jassoc.AssocInputs(gcol0=blk.gcol0, n_cols=blk.n_cols), B)
    jbits, _, jL0, jactive, _, _, jmad, jactive_b, _, _ = j
    ts = state_from_numpy(jax_state_numpy(js), "cpu")
    win = window_arrays(config_from_dataclass(cfg), ts, torch.tensor(int(blk.gcol0), dtype=torch.int32),
                        torch.tensor(int(blk.n_cols), dtype=torch.int32), B)
    H = cfg.clustering.max_steps_in_row
    az = jnp.float32(2.0 * math.pi / cfg.range_image.num_columns)
    jwp = jnp.minimum(jnp.ceil(jmad / az).astype(jnp.int32), H)
    jmax_wp = jnp.max(jnp.where(jactive_b, jwp, 0))
    return dict(cfg=cfg, win=win, jbits=jbits, jL0=jL0, jactive=jactive, jmad=jmad,
                jwp=jwp, jmax_wp=jmax_wp)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _kw(cfg):
    cl = cfg.clustering
    md = np.float32(cl.max_distance)
    return dict(H=cl.max_steps_in_row, V=cl.max_steps_in_column, max_d2=float(md * md))


def test_window_matches_jax(window):
    win = window["win"]
    np.testing.assert_array_equal(win.active_w.numpy(), np.asarray(window["jactive"]))
    np.testing.assert_array_equal(win.L0.numpy(), np.asarray(window["jL0"]))
    assert ulp_diff(np.asarray(window["jmad"]), win.mad.numpy()) <= 2
    assert int(win.active_w.sum()) > 100


def test_plain_edge_bits_match_xla_and_pallas(window, monkeypatch):
    cfg, win = window["cfg"], window["win"]
    args = (win.xw, win.yw, win.zw, win.incw, win.active_w)
    ref = cc_cuda.edge_bits_reference(*args, _t(window["jmad"]), _t(window["jwp"]), **_kw(cfg))
    jbits = np.asarray(window["jbits"])
    assert np.count_nonzero(jbits) > 0
    np.testing.assert_array_equal(ref.numpy(), jbits)
    # the port's own mad (correctly rounded arcsin) gives the same bits here
    np.testing.assert_array_equal(
        cc_cuda.edge_bits(*args, win.mad, win.wp, **_kw(cfg)).numpy(), jbits)
    monkeypatch.setenv("CCT_PALLAS_INTERPRET", "1")
    pbits, _ = edge_bits_pallas(
        cfg, *[jnp.asarray(a.numpy()) for a in args[:4]], jnp.asarray(win.active_w.numpy()),
        window["jmad"], window["jwp"], window["jmax_wp"])
    np.testing.assert_array_equal(np.asarray(pbits), ref.numpy())


def test_plain_window_cc_matches_vectorized_and_pallas(window, monkeypatch):
    cfg = window["cfg"]
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    jbits, jL0, jactive = window["jbits"], window["jL0"], window["jactive"]
    L, ok, rounds = cc_cuda.window_cc_reference(
        _t(jbits), _t(jL0), _t(window["jmax_wp"]).reshape(1), H=H, V=V)
    jl, jok, jrounds = jassoc._window_cc_vectorized(cfg, jbits, jactive, jL0, B, window["jmax_wp"])
    np.testing.assert_array_equal(L.numpy(), np.asarray(jl))
    assert bool(ok) and bool(jok)
    assert int(rounds) == int(jrounds) >= 1
    # some labels moved: the window holds components to merge
    assert not np.array_equal(L.numpy(), np.asarray(jL0))

    monkeypatch.setenv("CCT_PALLAS_INTERPRET", "1")
    win = window["win"]
    _, brev = edge_bits_pallas(
        cfg, *[jnp.asarray(a.numpy()) for a in (win.xw, win.yw, win.zw, win.incw)],
        jactive, window["jmad"], window["jwp"], window["jmax_wp"])
    pl, pok, _ = window_cc_pallas(cfg, jbits, brev, jactive, jL0, B, window["jmax_wp"])
    np.testing.assert_array_equal(np.asarray(pl), L.numpy())
    assert bool(pok)


def test_wrappers_route_cpu_tensors_to_the_twins(window):
    """A CPU tensor takes the plain twin and launches nothing; a tensor on
    another device type is refused."""
    cfg, win = window["cfg"], window["win"]
    stats.reset_launch_counts()
    args = (win.xw, win.yw, win.zw, win.incw, win.active_w, win.mad, win.wp)
    bits = cc_cuda.edge_bits(*args, **_kw(cfg))
    kw = {k: v for k, v in _kw(cfg).items() if k != "max_d2"}
    max_wp = torch.where(win.active_w[:, kw["H"]:], win.wp, 0).max().reshape(1)
    L, ok, _ = cc_cuda.window_cc(bits, win.L0, max_wp, **kw)
    assert bool(ok) and L.dtype == torch.int32
    assert stats.LAUNCHES == {"edge_bits": 0, "window_cc": 0, "ground_segment": 0,
                              "sweep_probe": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        cc_cuda.edge_bits(*[a.to("meta") for a in args], **_kw(cfg))
    with pytest.raises(ValueError, match="unsupported device"):
        cc_cuda.window_cc(bits.to("meta"), win.L0.to("meta"), max_wp.to("meta"), **kw)


@pytest.mark.parametrize("case", ["random-0", "random-1", "dense-2", "snake"])
def test_plain_window_cc_matches_vectorized_on_synthetic_windows(case):
    """Dense random edge words (out-of-window and out-of-range bits
    included) and a snake that runs into the 64-round cap: labels,
    converged and rounds equal the JAX package's ``_window_cc_vectorized``."""
    cfg = small_cfg()
    H, V = cfg.clustering.max_steps_in_row, cfg.clustering.max_steps_in_column
    R, Bw = 32, 48
    if case == "snake":
        Bw = 96
        bits, L0, max_wp = cc_windows.snake_window(R, Bw, H, V)
    else:
        kind, seed = case.split("-")
        bits, L0, max_wp = cc_windows.random_window(
            R, Bw, H, V, density=0.01 if kind == "dense" else 0.002, seed=int(seed))
    L, ok, rounds = cc_cuda.window_cc_reference(bits, L0, max_wp, H=H, V=V)
    jl, jok, jrounds = jassoc._window_cc_vectorized(
        cfg, jnp.asarray(bits.numpy()), jnp.ones(L0.shape, bool), jnp.asarray(L0.numpy()), Bw,
        jnp.asarray(int(max_wp)))
    np.testing.assert_array_equal(L.numpy(), np.asarray(jl))
    assert bool(ok) == bool(jok) == (case != "snake")
    assert int(rounds) == int(jrounds) >= (cc_cuda.MAX_ROUNDS if case == "snake" else 2)
