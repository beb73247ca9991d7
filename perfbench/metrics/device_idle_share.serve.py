"""The share of the profiled stretch of serving in which no operation ran
on the device, in %.
None when the run has nothing to read."""


def read(record):
    prof = record.get("profile")
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]) if prof and prof["busy_s"] else None
