"""continuous_clustering_tpu_torch — the PyTorch + CUDA port of the streaming
continuous-clustering engine.

The JAX package ``continuous_clustering_tpu`` stays the reference; this
package mirrors its layout so each module's counterpart is easy to find:

* ``ops``     — ring state, ingest, ground segmentation, association
                (with the two hand-written CUDA kernels in ``ops/cc_cuda.py``
                and ``csrc/``), packed readout
* ``models``  — ``pipeline_step_block``, host insertion and the streaming
                ``ContinuousClustering`` facade
* ``io``      — native slab -> point-cloud assembly
* ``native``  — builds and loads the shared C++ host library
* ``convert`` — JAX-state <-> port-state conversion through numpy

The port imports ``torch`` and never ``jax``.  Modules of the JAX package
that contain no JAX (``config``, ``constants``, ``io/point_cloud``,
``evaluation``, ``ops/oracle``) are imported from it as they are.
"""

from continuous_clustering_tpu.config import Config, kitti_config

__all__ = ["Config", "kitti_config"]
