"""Device meshes and sharded states (port of
``continuous_clustering_tpu/parallel/mesh.py``).

The workload's natural parallel axes:

* ``dp`` — data parallelism over independent sensor streams (the reference's
  multi-sensor deployment runs one pipeline per sensor,
  launch/demo_touareg.launch:20-31);
* ``sp`` — spatial parallelism over the ring-buffer column axis (the
  continuous azimuth dimension), the analog of sequence parallelism for the
  unbounded range image.

A ``Mesh`` is a (dp, sp) grid of ``torch.device``s; one device may appear
more than once (every shard on one card, or on the CPU in the tests).  A
``ShardedState`` holds one ``RingState`` per grid cell: the ring arrays
keep the cell's slice of the column axis (and, for a stacked state, its dp
row's sensors), every other field is replicated over sp (and sliced over
dp when stacked).  ``shard_pytree`` makes one from a ``RingState``,
``gather_state`` is its inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.state import RingState

FIELDS = tuple(f.name for f in dataclasses.fields(RingState))
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of devices."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the grid once, in row-major order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def _normalize(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (the visible CUDA devices unless the
    caller names others), cut to the first ``n_devices``.  As in the JAX
    package, ``dp`` defaults to 2 when the count is even and above 1, and
    sp = n // dp.  Raises without a card unless ``devices`` are named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(devices=[...]) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_normalize(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    if sp < 1:
        raise ValueError(f"make_mesh: dp={dp} needs at least {dp} devices, got {n}")
    return Mesh(tuple(tuple(devs[i * sp:(i + 1) * sp]) for i in range(dp)))


def state_sharding(mesh: Mesh, stacked: bool = True) -> Callable[[torch.Tensor], Spec]:
    """The placement of each field of a (stacked) ``RingState``, as the axis
    name each tensor axis is split over (None: not split): ring arrays
    ([S,] R, ring_cols) split sensors over ``dp`` and columns over ``sp``;
    every other field splits sensors over ``dp`` only."""
    lead = ("dp",) if stacked else ()

    def spec_for(leaf: torch.Tensor) -> Spec:
        if leaf.dim() == len(lead) + 2:
            return lead + (None, "sp")
        return lead + (None,) * (leaf.dim() - len(lead))

    return spec_for


@dataclasses.dataclass
class ShardedState:
    """A ``RingState`` placed on a mesh: ``shards[i][j]`` is the part held by
    ``mesh.devices[i][j]``."""

    mesh: Mesh
    stacked: bool
    shards: List[List[RingState]]


def _split(t: torch.Tensor, spec: Spec, mesh: Mesh, i: int, j: int) -> torch.Tensor:
    for axis, name in enumerate(spec):
        if name is None:
            continue
        n, k = mesh.shape[name], (i if name == "dp" else j)
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {t.shape[axis]} does not split over "
                             f"{name}={n}")
        size = t.shape[axis] // n
        t = t.narrow(axis, k * size, size)
    return t


def shard_pytree(mesh: Mesh, state: RingState, stacked: bool = True) -> ShardedState:
    """Place ``state`` on ``mesh``: every shard owns copies of its slices,
    on its device."""
    spec = state_sharding(mesh, stacked)
    shards = [[RingState(**{
        n: _split(getattr(state, n), spec(getattr(state, n)), mesh, i, j).to(dev, copy=True)
        for n in FIELDS}) for j, dev in enumerate(row)] for i, row in enumerate(mesh.devices)]
    return ShardedState(mesh, stacked, shards)


def gather_state(sharded: ShardedState, device=None) -> RingState:
    """The whole ``RingState`` of a sharded one, on ``device`` (the mesh's
    first device unless named)."""
    mesh = sharded.mesh
    dev = mesh.devices[0][0] if device is None else torch.device(device)
    spec = state_sharding(mesh, sharded.stacked)
    out = {}
    for n in FIELDS:
        rows = []
        for shard_row in sharded.shards:
            parts = [getattr(sh, n).to(dev) for sh in shard_row]
            s = spec(parts[0])
            rows.append(torch.cat(parts, dim=s.index("sp")) if "sp" in s else parts[0])
        out[n] = torch.cat(rows) if "dp" in s else rows[0]
    return RingState(**out)


def stream_state(state: RingState, s: int) -> RingState:
    """Stream ``s`` of a stacked state: views of its slices."""
    return RingState(**{n: getattr(state, n)[s] for n in FIELDS})


def _pick(stacked: NamedTuple, s: int):
    """Stream ``s`` of a tuple of stacked tensors (a batch, poses, a calibration)."""
    return type(stacked)(*[t[s] for t in stacked])


def _to(tree: NamedTuple, dev: torch.device):
    return type(tree)(*[t.to(dev) for t in tree])
