"""Device ops of the port: ring state, ingest, ground segmentation, association, kernels, readout."""
