"""Several streams in one step (port of ``continuous_clustering_tpu/parallel/``)."""
