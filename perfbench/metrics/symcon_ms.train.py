"""Device ms per traced training step in the first-order symmetric-contraction
kernels (``symcon_fwd`` and ``symcon_bwd``, every layer's launches) over the
profiled stretch.
None when the run has nothing to read."""
FIRST_ORDER = ("symcon_fwd", "symcon_bwd")


def read(record):
    prof = record.get("profile")
    if not prof or not prof["steps"]:
        return None
    seen = [prof["kernels"][k] for k in FIRST_ORDER if k in prof["kernels"]]
    if not sum(n for _, n in seen):
        return None
    return 1e3 * sum(s for s, _ in seen) / prof["steps"]
