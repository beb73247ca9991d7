"""Device busy time per bin served over the profiled stretch, in ms.
None when the run has nothing to read."""


def read(record):
    prof = record.get("profile")
    return 1e3 * prof["busy_s"] / prof["bins"] if prof and prof["busy_s"] else None
