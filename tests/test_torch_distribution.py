"""Port parity, the data distribution: the rest of Algorithm 1 (two-level
packing, the first- and best-fit baselines, the balance metrics, the
assignment vector) and the hierarchical sampler, held equal to the JAX
package's bin for bin and field for field on seeded size lists and on the
Table-3 mixture of ``SyntheticCFMDataset``.  Numpy only: exact equality.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import binpack as jbp
from repro.data.molecules import SyntheticCFMDataset as JDataset
from repro.data.sampler import HierarchicalBalancedSampler as JHier
from repro.data.sampler import SamplerState as JState
from repro_torch.core import binpack as bp
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.data.sampler import HierarchicalBalancedSampler, SamplerState
from repro_torch.launch import bench_distribution, pack_and_balance


def _sizes(kind):
    if kind == "table3":
        sizes = SyntheticCFMDataset(3000, seed=0).sizes
        assert np.array_equal(sizes, JDataset(3000, seed=0).sizes)
        return sizes
    rng = np.random.default_rng(int(kind))
    return rng.integers(1, 769, size=int(rng.integers(50, 400)))


SIZE_KINDS = ["0", "1", "7", "table3"]


def _same_bins(got, want):
    assert got.bins == want.bins
    assert got.capacity == want.capacity
    assert np.array_equal(np.asarray(got.sizes), np.asarray(want.sizes))


@pytest.mark.parametrize("kind", SIZE_KINDS)
@pytest.mark.parametrize("n_ranks", [1, 3, 8])
@pytest.mark.parametrize("name", ["first_fit_decreasing", "best_fit_decreasing",
                                  "create_balanced_batches"])
def test_flat_packings_match_jax(kind, n_ranks, name):
    sizes = _sizes(kind)
    got = getattr(bp, name)(sizes, 1024, n_ranks)
    want = getattr(jbp, name)(sizes, 1024, n_ranks)
    _same_bins(got, want)
    np.testing.assert_array_equal(got.loads(), want.loads())
    np.testing.assert_array_equal(got.work(), want.work())
    np.testing.assert_array_equal(got.work(lambda v: v ** 2), want.work(lambda v: v ** 2))
    np.testing.assert_array_equal(bp.assignment_vector(got, len(sizes)),
                                  jbp.assignment_vector(want, len(sizes)))


@pytest.mark.parametrize("kind", SIZE_KINDS)
@pytest.mark.parametrize("topology", [(1, 4), (2, 2), (3, 2), (4, 1), (2, 3)])
def test_two_level_batches_match_jax(kind, topology):
    sizes = _sizes(kind)
    got = bp.two_level_batches(sizes, 1024, *topology)
    want = jbp.two_level_batches(sizes, 1024, *topology)
    _same_bins(got.flat, want.flat)
    assert (got.n_ranks, got.n_steps) == (want.n_ranks, want.n_steps)
    np.testing.assert_array_equal(got.rank_loads(), want.rank_loads())
    np.testing.assert_array_equal(got.node_loads(), want.node_loads())
    _same_bins(got.node_bins(), want.node_bins())


def _same_metrics(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


@pytest.mark.parametrize("kind", SIZE_KINDS)
@pytest.mark.parametrize("n_ranks", [1, 4])
@pytest.mark.parametrize("measured", [False, True])
def test_balance_metrics_match_jax(kind, n_ranks, measured):
    sizes = _sizes(kind)
    rng = np.random.default_rng(3)
    for got_b, want_b in [
        (bp.create_balanced_batches(sizes, 1024, n_ranks),
         jbp.create_balanced_batches(sizes, 1024, n_ranks)),
        (bp.fixed_count_batches(sizes, 5, n_ranks, shuffle=True, seed=2),
         jbp.fixed_count_batches(sizes, 5, n_ranks, shuffle=True, seed=2)),
    ]:
        work = (rng.uniform(0.5, 1.5, size=(got_b.n_bins // n_ranks, n_ranks))
                if measured else None)
        _same_metrics(bp.balance_metrics(got_b, n_ranks, measured_work=work),
                      jbp.balance_metrics(want_b, n_ranks, measured_work=work))


@pytest.mark.parametrize("measured", [False, True])
def test_two_level_metrics_match_jax(measured):
    sizes = _sizes("table3")
    got = bp.two_level_batches(sizes, 3072, 2, 2)
    want = jbp.two_level_batches(sizes, 3072, 2, 2)
    work = (np.random.default_rng(5).uniform(size=(got.n_steps, 4)) if measured
            else None)
    g = bp.two_level_metrics(got, measured_rank_work=work)
    w = jbp.two_level_metrics(want, measured_rank_work=work)
    assert g.keys() == w.keys() == {"rank", "node"}
    for level in g:
        _same_metrics(g[level], w[level])


def test_metrics_reject_a_wrong_work_matrix_and_empty_packings_are_neutral():
    b = bp.create_balanced_batches([5, 6, 7], 16, 2)
    with pytest.raises(ValueError, match="measured_work"):
        bp.balance_metrics(b, 2, measured_work=np.ones((1, 3)))
    with pytest.raises(ValueError, match="measured_rank_work"):
        bp.two_level_metrics(bp.two_level_batches([5, 6], 16, 1, 2),
                             measured_rank_work=np.ones((1, 3)))
    _same_metrics(bp.balance_metrics(bp.Bins([], [], 8), 2),
                  jbp.balance_metrics(jbp.Bins([], [], 8), 2))


def test_two_level_rejects_bad_topology():
    for topology in [(0, 2), (2, 0)]:
        with pytest.raises(ValueError):
            bp.two_level_batches([5, 6], 1024, *topology)


@pytest.mark.parametrize("topology", [(1, 4), (2, 2), (3, 2)])
def test_hierarchical_sampler_matches_jax(topology):
    sizes = SyntheticCFMDataset(400, seed=4, max_atoms=64).sizes
    ours = HierarchicalBalancedSampler(sizes, 128, *topology, seed=3)
    theirs = JHier(sizes, 128, *topology, seed=3)
    assert ours.n_ranks == theirs.n_ranks == topology[0] * topology[1]
    for epoch in (0, 1, 2):
        assert ours.bins_for_epoch(epoch) == theirs.bins_for_epoch(epoch)
        assert ours.steps_per_epoch(epoch) == theirs.steps_per_epoch(epoch)
        assert (list(ours.step_iter(SamplerState(epoch, 1)))
                == list(theirs.step_iter(JState(epoch, 1))))
    # unshuffled, the packing is the two-level one, node-major
    flat = HierarchicalBalancedSampler(sizes, 128, *topology, shuffle_bins=False)
    assert flat.bins_for_epoch(0) == bp.two_level_batches(sizes, 128, *topology).flat.bins


def test_paper_comparison_scripts_run(capsys):
    rows = bench_distribution.main(n=2000, n_ranks=4)
    assert [r.split(",")[1] for r in rows[:4]] == [
        "fixed_count_4", "ffd_3072", "bfd_3072", "balanced_3072"]
    pack_and_balance.main(n_graphs=2000, n_ranks=8)
    out = capsys.readouterr().out
    assert "algorithm1_balanced" in out and "two-level 4x2" in out and out.endswith("OK\n")
