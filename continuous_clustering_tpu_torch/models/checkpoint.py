"""Checkpoint / resume of the streaming facade (port of
``continuous_clustering_tpu/models/checkpoint.py``).

The snapshot is the ring state plus the host-side frontier mirrors, as one
``.npz`` in the JAX package's layout: one array per ``RingState`` field
(u32 fields as uint32, which the port holds as int32 bit patterns and
reinterprets, never converts by value), ``_h_mirrors`` = [first unfinished,
first unpublished, cluster counter, origin rotation] as int64 and
``_num_rows``.  A file either package writes loads into the other.

The native host-insertion engine's ring is not serialized: a resumed
facade streams on through device insertion, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from ..convert import FIELD_NAMES, state_from_numpy, state_to_numpy


def save_state(pipe, path) -> None:
    """Flush ``pipe`` (a ``ContinuousClustering``) and write its snapshot to
    ``path`` (``.npz``)."""
    pipe.flush()
    arrays = state_to_numpy(pipe.state)
    arrays["_h_mirrors"] = np.asarray(
        [pipe._h_first_unfinished, pipe._h_first_unpublished,
         pipe._h_cluster_counter, pipe._h_origin_rot], np.int64)
    arrays["_num_rows"] = np.asarray(pipe.num_rows)
    np.savez_compressed(path, **arrays)


def load_state(pipe, path) -> None:
    """Restore a snapshot into ``pipe`` (same configuration and firing
    batch size), on ``pipe``'s device; it resumes on device insertion."""
    with np.load(path) as data:
        pipe._insertion = "device"
        pipe.reset(int(data["_num_rows"]))
        # fields added after the snapshot was taken keep their initial value
        arrays = state_to_numpy(pipe.state)
        arrays.update({name: data[name] for name in FIELD_NAMES if name in data})
        mirrors = [int(v) for v in data["_h_mirrors"]]
    pipe._state = state_from_numpy(arrays, pipe.state.device)
    (pipe._h_first_unfinished, pipe._h_first_unpublished,
     pipe._h_cluster_counter, pipe._h_origin_rot) = mirrors
