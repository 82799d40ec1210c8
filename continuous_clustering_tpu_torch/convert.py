"""Conversion between the JAX package's ``RingState`` and ``Config`` and the
port's.

The exchange format is a dict of numpy arrays keyed by field name, so this
module needs no JAX: the JAX side is ``{f.name: np.asarray(getattr(s, f.name))
for f in dataclasses.fields(s)}``.  u32 fields cross as uint32 and are held
by the port as int32 bit patterns.  A configuration crosses as
``dataclasses.asdict``: the two packages share no class.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from . import config as _config
from .ops.state import U32_FIELDS, RingState

FIELD_NAMES = tuple(f.name for f in dataclasses.fields(RingState))


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> RingState:
    kw = {}
    for name in FIELD_NAMES:
        a = np.asarray(arrays[name])
        if name in U32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        kw[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return RingState(**kw)


def state_to_numpy(state: RingState) -> Dict[str, np.ndarray]:
    out = {}
    for name in FIELD_NAMES:
        a = getattr(state, name).detach().cpu().numpy().copy()
        if name in U32_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out


def config_from_dataclass(cfg) -> _config.Config:
    """The port's ``Config`` with the values of ``cfg``, any dataclass of the
    same nested layout (the JAX package's ``Config``), through
    ``dataclasses.asdict``."""
    groups = dataclasses.asdict(cfg)
    kw = {f.name: f.type for f in dataclasses.fields(_config.Config)}
    return _config.Config(**{
        name: getattr(_config, kw[name])(**vals) for name, vals in groups.items()})
