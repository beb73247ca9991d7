"""Model FLOPs of the window's steps (7 forwards each, at the bins' real
atoms and edges) over the window times the fp32 peak, in %.
None when the run has nothing to read."""


def read(record):
    flops = record.get("model_flops") or []
    return 100.0 * sum(flops) / (record["window_s"] * record["peak_flops"]) if flops else None
