"""The port's probe variants (``ops/sweep_probe.py``) against the JAX kernels
of ``scripts/pallas_bisect.py``, run through ``pl.pallas_call(...,
interpret=True)`` with the script's own block specs and scratch shapes.

Inputs are made from a numpy seed: dense random edge words (every bit
pattern, negative words included) and labels in [-4, 8), so that the
minimum variants find smaller neighbours, ``V5``'s window around 3 and its
``|nb| <= 2`` test both hold somewhere, and ``V6``'s ``|nb| < 5`` test takes
both values.  ``upper`` runs over 1, 7 and 21 = H + 1.  Tolerance: exact.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from continuous_clustering_tpu_torch.ops import sweep_probe as sp
from continuous_clustering_tpu_torch.tools import sweep_probe as tool
from continuous_clustering_tpu_torch.utils import stats

from .test_torch_step import one_torch_thread  # noqa: F401

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "pallas_bisect.py"
KERNELS = {"V0_init_copy": "k0", "V1_static_slice_roll": "k1", "V2_dynamic_roll": "k2",
           "V3_bool_mask": "k3", "V3i_i32_mask": "k3i", "V4_mask_scratch": "k4",
           "V5_cmp_astype_prefix": "k5", "V6_bitpack": "k6"}
_JITTED = {}


def _script():
    spec = importlib.util.spec_from_file_location("pallas_bisect", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_probe(name):
    """The script's kernel ``name`` under ``pallas_call`` in interpret mode,
    with the specs of the script's ``probe``; jitted once per kernel."""
    if name not in _JITTED:
        m = _script()
        kernel = getattr(m, KERNELS[name])
        call = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((m.R, m.WCOL), jnp.int32),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1), memory_space=pltpu.SMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((m.R + 2 * m.V, m.PW), jnp.int32) for _ in range(2)],
            interpret=True,
        )
        _JITTED[name] = jax.jit(call)
    return _JITTED[name]


def test_constants_match_the_script():
    m = _script()
    assert (sp.H, sp.V, sp.R, sp.B) == (m.H, m.V, m.R, m.B)
    assert sp.padded_width(m.H, m.WCOL) == m.PW
    assert sp.DR_IDX == tuple(range(0, m.n_dr, 17))
    assert list(sp.VARIANTS) == list(KERNELS)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("upper", [1, 7, 21])
@pytest.mark.parametrize("name", list(KERNELS))
def test_twin_equals_interpret_mode_pallas(name, upper, seed):
    bits, L = tool.probe_inputs(seed)
    want = np.asarray(jax_probe(name)(jnp.asarray(bits), jnp.full((1, 1), upper, jnp.int32),
                                      jnp.asarray(L)))
    got = sp.sweep_probe(name, torch.from_numpy(bits), torch.tensor(upper, dtype=torch.int32),
                         torch.from_numpy(L))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name != "V0_init_copy":
        assert np.any(want != L), "the inputs leave this variant's output unchanged"


def test_tool_runs_the_twins_on_the_cpu(capsys):
    stats.reset_launch_counts()
    assert tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{name}: OK" for name in KERNELS]
    assert stats.LAUNCHES == {"edge_bits": 0, "window_cc": 0, "ground_segment": 0,
                              "sweep_probe": 0}


def test_wrapper_refuses_other_devices_and_names():
    bits, L = tool.probe_inputs(0)
    with pytest.raises(ValueError, match="unknown"):
        sp.sweep_probe("V7", torch.from_numpy(bits), torch.tensor(1), torch.from_numpy(L))
    with pytest.raises(ValueError, match="unsupported device"):
        sp.sweep_probe("V0_init_copy", torch.from_numpy(bits).to("meta"),
                       torch.tensor(1, device="meta"), torch.from_numpy(L).to("meta"))
