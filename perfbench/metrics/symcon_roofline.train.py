"""The first-order symmetric-contraction kernels' share of their roofline
over the profiled stretch, in %: each launch's bound (``counts/kernels.py``,
at the stretch's mean real atoms) over the launches' device time.  The
spec is the one the ``model.symcon`` span's counters give (channels,
hidden and atomic-basis l up to their maxima, correlation).
None when the run has nothing to read, or its program has no such span."""
from perfbench.counts import kernels as kcounts
from perfbench.reference.mace import Config
from perfbench.spans import spans

FIRST_ORDER = ("symcon_fwd", "symcon_bwd")


def spec_config(counts):
    """A reference ``Config`` with the counters' spec; the fields the
    symmetric contraction's counts do not read are placeholders."""
    return Config(n_species=1, channels=int(counts["channels"]),
                  hidden_ls=tuple(range(int(counts["hidden_lmax"]) + 1)), sh_lmax=0,
                  a_ls=tuple(range(int(counts["a_lmax"]) + 1)),
                  correlation=int(counts["correlation"]), n_interactions=1, r_max=0.0,
                  num_bessel=0, radial_mlp=(), readout_mlp=0, avg_num_neighbors=1.0)


def read(record):
    prof = record.get("profile")
    traced = spans("model.symcon")
    if not prof or not prof["steps"] or not traced:
        return None
    cfg = spec_config(traced[-1].counts)
    dev = sum(prof["kernels"][k][0] for k in FIRST_ORDER if k in prof["kernels"])
    if dev <= 0:
        return None
    bound = sum(prof["kernels"][k][1] * kcounts.bound_s(
        *kcounts.work(k, cfg, 0, prof["mean_atoms"], prof["mean_edges"]))
        for k in FIRST_ORDER if k in prof["kernels"])
    return 100.0 * bound / dev
