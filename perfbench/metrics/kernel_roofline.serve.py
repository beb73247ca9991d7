"""The four CUDA kernels' share of their roofline over the profiled
stretch of serving, in %, as for training.
None when the run has nothing to read."""


def read(record):
    prof = record.get("profile")
    share = prof and prof.get("kernel_share")
    return 100.0 * share if share else None
