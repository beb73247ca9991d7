"""Algorithm 1 walkthrough, the port's copy of ``examples/pack_and_balance.py``:
pack a Table-3-like dataset, show the balance / padding / straggler wins
over fixed-count batching and the first- and best-fit heuristics, the
two-level packing's node balance, and the elastic re-pack for a new device
count in milliseconds.  Output goes to stdout.

    PYTHONPATH=src python -m repro_torch.launch.pack_and_balance
"""
from __future__ import annotations

import time

from repro_torch.core.binpack import (
    balance_metrics,
    best_fit_decreasing,
    create_balanced_batches,
    first_fit_decreasing,
    fixed_count_batches,
    two_level_batches,
    two_level_metrics,
)
from repro_torch.data.molecules import SyntheticCFMDataset


def main(n_graphs: int = 50_000, n_ranks: int = 16, cap: int = 3072) -> None:
    ds = SyntheticCFMDataset(n_graphs, seed=0)
    print(f"{len(ds)} graphs, sizes {ds.sizes.min()}..{ds.sizes.max()}")

    print(f"{'method':<22}{'bins':>7}{'padding':>9}{'straggler':>11}{'cv':>8}")
    for name, packed in [
        ("fixed_count_6", fixed_count_batches(ds.sizes, 6, n_ranks, shuffle=True)),
        ("first_fit_decreasing", first_fit_decreasing(ds.sizes, cap, n_ranks)),
        ("best_fit_decreasing", best_fit_decreasing(ds.sizes, cap, n_ranks)),
        ("algorithm1_balanced", create_balanced_batches(ds.sizes, cap, n_ranks)),
    ]:
        m = balance_metrics(packed, n_ranks)
        print(f"{name:<22}{m.n_bins:>7}{m.padding_fraction:>9.3f}"
              f"{m.straggler_ratio:>11.3f}{m.load_cv:>8.3f}")

    # the pod form: 4 nodes x 4 devices, both levels of the two-level packing
    m = two_level_metrics(two_level_batches(ds.sizes, cap, 4, n_ranks // 4))
    print(f"two-level 4x{n_ranks // 4}: rank straggler {m['rank'].straggler_ratio:.3f}, "
          f"node straggler {m['node'].straggler_ratio:.3f}")

    # elastic rescale: node failure 16 -> 12 ranks, re-pack on the fly
    t0 = time.perf_counter()
    repacked = create_balanced_batches(ds.sizes, cap, 12)
    dt = time.perf_counter() - t0
    m = balance_metrics(repacked, 12)
    print(f"\nelastic 16->12 ranks: re-packed {len(ds)} graphs in {dt*1e3:.0f} ms "
          f"(straggler {m.straggler_ratio:.3f}, bins {m.n_bins})")
    print("OK")


if __name__ == "__main__":
    main()
