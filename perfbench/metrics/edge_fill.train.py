"""The real edges of the window's bins over their edge slots (steps x
capacity x edge_factor), in %: the share of the per-edge work that is not
spent on padding.
None when the run has nothing to read."""


def read(record):
    steps = len(record.get("edges") or [])
    return 100.0 * sum(record["edges"]) / (steps * record["edge_slots"]) if steps else None
