"""The real edges of the traced bins over their edge slots (the buckets'
``max_edges``), in %: the share of serving's per-edge work that is not
spent on padding.
None when nothing was traced."""
from perfbench.spans import spans


def read(record):
    bins = spans("serve.bin")
    slots = sum(s.counts["edge_slots"] for s in bins)
    return 100.0 * sum(s.counts["edges"] for s in bins) / slots if slots else None
