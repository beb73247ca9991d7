"""Device busy time per training step over the profiled stretch, in ms.
None when the run has nothing to read."""


def read(record):
    prof = record.get("profile")
    return 1e3 * prof["busy_s"] / prof["steps"] if prof and prof["steps"] else None
