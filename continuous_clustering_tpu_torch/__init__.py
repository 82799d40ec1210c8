"""continuous_clustering_tpu_torch — the PyTorch + CUDA port of the streaming
continuous-clustering engine.

The JAX package ``continuous_clustering_tpu`` stays the reference; this
package mirrors its layout so each module's counterpart is easy to find:

* ``ops``        — ring state, device insertion, ingest, ground
                   segmentation, association (with the two hand-written CUDA
                   kernels in ``ops/cc_cuda.py`` and ``csrc/``), packed
                   readout, and the sequential oracle
* ``models``     — ``pipeline_step`` and ``pipeline_step_block``, host
                   insertion, the streaming ``ContinuousClustering`` facade,
                   checkpoint/resume and the scan runners
* ``io``         — point-cloud schemas, native slab -> cloud assembly, the
                   middleware-free ``ClusteringNode`` with its transform
                   synchronizer and publish messages, the ROS1 bag reader
* ``sensors``    — Velodyne and Ouster packet decoders (native, or their
                   NumPy twins when asked) and the generic points input
* ``launch``     — the reference's vehicle, sensor and demo presets
* ``evaluation`` — synthetic scenes, partition comparison, the SemanticKITTI
                   loader, euclidean ground truth and the OSE/USE metrics
* ``tools``      — throughput measurement set-up (``bench_setup``), the
                   multi-sensor demo, rosbag replay, the latency bench, the
                   KITTI demo and its dataset and ground-truth tools, the
                   viewers
* ``native``     — builds and loads the C++ host library from ``csrc/host``
* ``convert``    — JAX-state <-> port-state and config conversion through numpy

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: the modules it shares with it (``config``, ``constants``,
``io/point_cloud``, ``evaluation``, ``ops/oracle`` and the C++ host sources)
are its own copies.  Entry points run on the card (``device=None`` means
``cuda``) unless the caller asks for the CPU.
"""

from .config import (
    ClusteringConfig,
    Config,
    GeneralConfig,
    GroundSegmentationConfig,
    RangeImageConfig,
    kitti_config,
    ouster_os32_config,
    vls128_roof_config,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "GeneralConfig",
    "RangeImageConfig",
    "GroundSegmentationConfig",
    "ClusteringConfig",
    "kitti_config",
    "vls128_roof_config",
    "ouster_os32_config",
]
