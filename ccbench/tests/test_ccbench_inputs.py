"""A seed gives the same inputs twice, and another seed other ones."""

from __future__ import annotations

import numpy as np
import torch

from ccbench import harness
from ccbench.drivers import facade, node
from ccbench.tests.small import SEED, small_cell


def _facade(seed, cell="kitti_hdl64.standard.host"):
    c = small_cell(cell)
    return facade.Driver(None, c.config, c.traffic, seed, torch.device("cpu"))


def test_facade_firings_repeat_per_seed():
    a, b, other = _facade(SEED), _facade(SEED), _facade(SEED + 1)
    for k in (0, 5, 219, 220, 1000):
        fa, fb = a.firing(k), b.firing(k)
        for key in ("xyz", "stamp", "uidx", "intensity"):
            np.testing.assert_array_equal(fa[key], fb[key])
    assert not np.array_equal(np.nan_to_num(a.xyz), np.nan_to_num(other.xyz))


def test_revolution_k_is_revolution_0_shifted():
    d = _facade(SEED)
    C, R = d.C, d.R
    f0, f3 = d.firing(7), d.firing(3 * C + 7)
    np.testing.assert_array_equal(f0["xyz"], f3["xyz"])
    assert int(f3["stamp"][0]) - int(f0["stamp"][0]) == 3 * d.rev_ns
    assert int(f3["uidx"][0]) - int(f0["uidx"][0]) == 3 * C * R


def test_node_packets_repeat_per_seed():
    c = small_cell("touareg_vls128.packets.node")
    a = node.Driver(None, c.config, c.traffic, SEED, torch.device("cpu"))
    b = node.Driver(None, c.config, c.traffic, SEED, torch.device("cpu"))
    assert a.packets == b.packets
    n = len(a.packets)
    s0, p0 = a.packet(3)
    s2, p2 = a.packet(2 * n + 3)
    assert p0 == p2 and s2 - s0 == 2 * a.rev_ns
    # the reference decodes the packets into whole revolutions of firings
    f = a.reference_firing(a.C + 5)
    np.testing.assert_array_equal(np.isnan(f["xyz"][:, 0]), np.isnan(a.reference_firing(5)["xyz"][:, 0]))


def test_large_seeds_are_accepted():
    d = _facade(2**31 + 2**30 + 12345)
    assert np.isfinite(d.xyz).any()
    assert harness.load_cell("kitti_hdl64.standard.host").traffic["loop"] == "closed"
