"""The four CUDA kernels' share of their roofline over the profiled
stretch, in %: the sum of each launch's bound at the bins' real counts
over the sum of the launches' device time.
None when the run has nothing to read."""


def read(record):
    prof = record.get("profile")
    share = prof and prof.get("kernel_share")
    return 100.0 * share if share else None
