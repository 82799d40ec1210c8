"""The port's ring state against the JAX package's: allocation, the numpy
round trip of ``convert.py``, ring reads and writes across the wrap, the
bounded clear and the azimuth rebase.

Tolerance: every field exact (these ops only move, select or shift values;
the rebase subtracts the same f32 shift).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from continuous_clustering_tpu.ops import state as jstate
from continuous_clustering_tpu_torch.convert import (config_from_dataclass, state_from_numpy,
                                                     state_to_numpy)
from continuous_clustering_tpu_torch.ops import state as tstate

from .test_torch_step import (assert_states_equal, jax_state_numpy, one_torch_thread,  # noqa: F401
                              small_cfg, stream_states)

R = 32


@pytest.fixture(scope="module")
def streamed():
    """Numpy JAX state after six steps (more than a revolution) of a scene."""
    return stream_states(small_cfg(), R, 48, n_steps=6)[-1]


def test_init_state_matches_jax_and_round_trips():
    cfg = small_cfg()
    js = jax_state_numpy(jstate.init_state(cfg, R))
    ts = tstate.init_state(config_from_dataclass(cfg), R, "cpu")
    assert_states_equal(js, state_to_numpy(ts), "init")
    back = state_to_numpy(state_from_numpy(js, "cpu"))
    for name, a in js.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_convert_round_trips_a_streamed_state(streamed):
    """A state after a revolution of real data crosses to the port and back
    bit for bit (uint32 fields included)."""
    js = streamed
    back = state_to_numpy(state_from_numpy(js, "cpu"))
    for name, a in js.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    assert js["uidx_lo"].dtype == np.uint32


@pytest.mark.parametrize("lcol0,width", [(0, 7), (50, 20), (215, 20), (219, 1), (210, 64)])
def test_ring_read_write_across_the_wrap(lcol0, width):
    rng = np.random.default_rng(lcol0 + width)
    rc = 220
    arr = rng.standard_normal((R, rc)).astype(np.float32)
    vals = rng.standard_normal((R, width)).astype(np.float32)
    got = tstate.ring_read(torch.from_numpy(arr), torch.tensor(lcol0, dtype=torch.int32), width)
    want = jstate.ring_read(jnp.asarray(arr), jnp.int32(lcol0), width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = torch.from_numpy(arr.copy())
    tstate.ring_write(t, lcol0, torch.from_numpy(vals))
    want = jstate.ring_write(jnp.asarray(arr), jnp.int32(lcol0), jnp.asarray(vals))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


@pytest.mark.parametrize("cleared_to,target", [(0, 30), (100, 120), (200, 260), (5, 3)])
def test_clear_columns_chunk_matches_jax(streamed, cleared_to, target):
    """The gcol-gated chunk clear over a streamed state (the later columns
    of the window hold fresh data that must survive)."""
    js = streamed
    j_state = jstate.RingState(**{k: jnp.asarray(v) for k, v in js.items()})
    j_out, j_to = jstate.clear_columns_chunk(j_state, jnp.int32(cleared_to), jnp.int32(target), 48)
    t_out, t_to = tstate.clear_columns_chunk(
        state_from_numpy(js, "cpu"), torch.tensor(cleared_to, dtype=torch.int32),
        torch.tensor(target, dtype=torch.int32), 48)
    assert int(t_to) == int(j_to)
    assert_states_equal(jax_state_numpy(j_out), state_to_numpy(t_out), "clear")


def test_rebase_azimuth_matches_jax(streamed):
    js = streamed
    j_state = jstate.RingState(**{k: jnp.asarray(v) for k, v in js.items()})
    j_out, _ = jstate.rebase_azimuth(j_state, 3)
    t_out, rot = tstate.rebase_azimuth(state_from_numpy(js, "cpu"), 3)
    assert rot == 3
    assert_states_equal(jax_state_numpy(j_out), state_to_numpy(t_out), "rebase")
