"""The node's host time per sensor revolution, in the window before the
profiled slice: the self time of the program's ``node.*`` spans (packet
enqueue, decoder poll, the per-firing path with its transform sync, the
facade's batches left out) over the ``node.firings`` counter in
revolutions of the sensor's columns, in ms."""

from ccbench.program_trace import before_slice


def read(run):
    w = before_slice(run)
    firings = w["counts"].get("node.firings", 0) if w is not None else 0
    if not firings:
        return None
    node_ns = sum(s["self_ns"] for name, s in w["spans"].items() if name.startswith("node."))
    return node_ns / 1e6 / (firings / run.cell.config["sensor"]["columns"])
