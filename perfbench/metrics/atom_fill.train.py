"""The real atoms of the window's bins over their rows (steps x capacity),
in %: how full Algorithm 1 packs the bins.
None when the run has nothing to read."""


def read(record):
    steps = len(record.get("atoms") or [])
    return 100.0 * sum(record["atoms"]) / (steps * record["capacity"]) if steps else None
