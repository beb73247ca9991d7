"""The benchmark's frozen counts and graphs against the originals they were
copied from: model FLOPs against ``roofline/analytic.py::mace_cell_cost`` at
the padded counts, the symmetric contraction's kernel work against
``chip_smoke.py``'s grouping, the CG entries against the port's tables; the
generator's graphs against the port's ``SyntheticCFMDataset``; and the edge
slots a bin of ``mace_mp0_medium`` needs at 6 A."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.counts import kernels, model
from perfbench.datagen import TABLE3_MIXTURE, GraphSet, cutoff_edges, make_molecule
from perfbench.reference.mace import Config
from repro_torch.configs.mace_cfm import CONFIG
from repro_torch.data.molecules import SyntheticCFMDataset, _cutoff_edges
from repro_torch.data.sampler import BalancedBatchSampler, SamplerState
from repro_torch.kernels.channelwise_tp import kernel as tpk
from repro_torch.kernels.symmetric_contraction import kernel as sck
from repro_torch.roofline.analytic import mace_cell_cost


def _port_config(correlation):
    return dataclasses.replace(CONFIG, correlation=correlation)


def _ref_config(port):
    return Config.from_fields({f.name: getattr(port, f.name) for f in dataclasses.fields(port)})


@pytest.mark.parametrize("correlation", [2, 3])
@pytest.mark.parametrize("capacity,edge_factor", [(3072, 48), (768, 64)])
def test_model_flops_equal_mace_cell_cost_at_padded_counts(correlation, capacity, edge_factor):
    port = _port_config(correlation)
    want = mace_cell_cost(port, 1, capacity, edge_factor)["model_flops"]
    got = model.TRAIN_FACTOR * model.forward_flops(_ref_config(port), capacity,
                                                   capacity * edge_factor)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("correlation", [2, 3])
def test_symcon_work_uses_the_kernels_grouping(correlation):
    port = _port_config(correlation)
    spec = port.symcon_spec()
    groups, p_total = sck._group_entries(spec, sck.build_symcon_tables(spec))
    mine, p_mine = kernels.symcon_groups(_ref_config(port))
    assert p_mine == p_total
    assert sorted(mine) == sorted((nu, n) for (_, _, nu, n, _) in groups)


def test_tp_entries_equal_the_kernels_tables():
    port = _port_config(2)
    ref = _ref_config(port)
    for layer in range(port.n_interactions):
        n_ent = len(tpk.tp_entries(port.tp_spec_at(layer)))
        assert model.tp_nnz(ref, layer) == n_ent
        _, ops = kernels.work("tp_scatter_fwd", ref, layer, 100, 1000)
        assert ops == 4 * 1000 * port.channels * n_ent


def test_roofline_share_is_bound_over_device_time():
    ref = _ref_config(_port_config(2))
    one = kernels.launch_bound_s("tp_gather_bwd", ref, 3000, 51000)
    share = kernels.roofline_share(ref, {"tp_gather_bwd": (4 * one / 0.5, 4)}, 3000, 51000)
    assert share == pytest.approx(0.5)
    assert kernels.roofline_share(ref, {"tp_gather_bwd": (0.0, 0)}, 3000, 51000) is None


@pytest.mark.parametrize("r_cut", [4.5, 6.0])
def test_graphs_equal_the_ports_generator(r_cut):
    seed = 2**31 + 12345
    ours = GraphSet(30, seed, r_cut, max_atoms=200)
    port = SyntheticCFMDataset(30, seed=seed, r_cutoff=r_cut, max_atoms=200)
    np.testing.assert_array_equal(ours.sizes, port.sizes)
    for i in range(30):
        a, b = ours.get(i), port.get(i)
        np.testing.assert_array_equal(a.species, b.species)
        np.testing.assert_array_equal(a.positions, b.positions)
        assert set(zip(a.senders.tolist(), a.receivers.tolist())) == set(
            zip(b.senders.tolist(), b.receivers.tolist()))
        assert a.energy == pytest.approx(b.energy, rel=1e-9, abs=1e-12)
        np.testing.assert_allclose(a.forces, b.forces, rtol=1e-5, atol=1e-6)


def test_vectorised_edges_equal_the_cell_list_on_dense_positions():
    pos = np.random.default_rng(3).random((300, 3)) * 12.0
    for r_cut in (4.5, 6.0):
        s, r = cutoff_edges(pos, r_cut)
        s2, r2 = _cutoff_edges(pos, r_cut)
        assert set(zip(s.tolist(), r.tolist())) == set(zip(s2.tolist(), r2.tolist()))


def test_mp0_bins_at_6A_fit_64_edge_slots_per_atom():
    config = harness.data_file("configs", "mace_mp0_medium")
    traffic = harness.data_file("traffic", "train_bins3072")
    ef, r_cut, cap = config["edge_factor"], config["r_max"], traffic["capacity"]
    # the densest graph of each system at its largest size
    for system, (_, _, (_, hi), _, _) in enumerate(TABLE3_MIXTURE):
        m = make_molecule(7, 0, system, hi, r_cut)
        assert m.n_edges < ef * m.n_atoms, TABLE3_MIXTURE[system][0]
    data = GraphSet(400, 2**32 + 7, r_cut)
    sampler = BalancedBatchSampler(data.sizes, cap, 1, seed=11)
    for (b,) in sampler.step_iter(SamplerState(0, 0)):
        assert int(data.edges[b].sum()) <= ef * cap
        assert int(data.sizes[b].sum()) <= cap


def test_configs_state_every_field_the_port_runs():
    from repro_torch.core.mace import MaceConfig

    fields = {f.name for f in dataclasses.fields(MaceConfig)}
    for name in ("mace_cfm", "mace_mp0_medium"):
        cfg = harness.data_file("configs", name)
        assert fields <= set(cfg), sorted(fields - set(cfg))
    cfm = harness.data_file("configs", "mace_cfm")
    for f in fields:
        want = getattr(CONFIG, f)
        assert (list(want) if isinstance(want, tuple) else want) == cfm[f], f
    assert json.dumps(cfm)
