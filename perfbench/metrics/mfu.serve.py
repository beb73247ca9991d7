"""Model FLOPs of the molecules served in the window (3 forwards each:
the forward and the forces) over the window times the fp32 peak, in %.
None when the run has nothing to read."""


def read(record):
    flops = record.get("model_flops")
    return 100.0 * flops / (record["window_s"] * record["peak_flops"]) if flops else None
