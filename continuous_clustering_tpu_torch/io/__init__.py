"""Host-side I/O of the port: native slab -> point-cloud assembly."""
