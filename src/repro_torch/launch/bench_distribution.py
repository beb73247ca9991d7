"""Paper Figure 12 + Observation 1, the port's copy of
``benchmarks/bench_distribution.py``: the token distribution across ranks
under fixed-graph-count batches, first-fit and best-fit decreasing, and
Algorithm 1's balanced bins (padding, load cv, straggler ratio), then each
one's per-rank tokens of the first step.  Rows go to stdout (no
``BENCH_*.json`` is written).

    PYTHONPATH=src python -m repro_torch.launch.bench_distribution
"""
from __future__ import annotations

from repro_torch.core.binpack import (
    balance_metrics,
    best_fit_decreasing,
    create_balanced_batches,
    first_fit_decreasing,
    fixed_count_batches,
)
from repro_torch.data.molecules import SyntheticCFMDataset


def main(n: int = 100_000, n_ranks: int = 8, capacity: int = 3072):
    ds = SyntheticCFMDataset(n, seed=0)
    packings = [
        ("fixed_count_4", fixed_count_batches(ds.sizes, graphs_per_batch=4,
                                              n_ranks=n_ranks, shuffle=True)),
        ("ffd_3072", first_fit_decreasing(ds.sizes, capacity, n_ranks)),
        ("bfd_3072", best_fit_decreasing(ds.sizes, capacity, n_ranks)),
        ("balanced_3072", create_balanced_batches(ds.sizes, capacity, n_ranks)),
    ]
    rows = []
    for name, b in packings:
        m = balance_metrics(b, n_ranks)
        rows.append(
            f"fig12,{name},bins={m.n_bins},load_mean={m.mean_load:.0f},"
            f"load_max={m.max_load},load_cv={m.load_cv:.3f},"
            f"padding={m.padding_fraction:.3f},straggler={m.straggler_ratio:.3f}"
        )
    # per-rank token totals for the first step (the Fig 12 snapshot)
    for name, b in packings:
        loads = b.loads()[:n_ranks]
        rows.append(f"fig12_snapshot,{name},per_rank_tokens={'|'.join(map(str, loads))}")
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
