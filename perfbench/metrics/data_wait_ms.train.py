"""How long each step of the window waited for its batch from the prefetch
pipeline (``RankTelemetry.host_wait``), in ms, the mean over the steps.
None when the run has nothing to read."""


def read(record):
    waits = record.get("wait_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
