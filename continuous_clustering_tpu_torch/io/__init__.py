"""Host-side I/O of the port: point-cloud schemas and native slab -> point-cloud assembly."""
