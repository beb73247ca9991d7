"""The benchmark's plain reference against the port's plain path (the
``ref`` impls, on the CPU) at a small size on seeded weights: the parameter
layout, energies, forces, the weighted loss and its gradients, and one
clip + AdamW + EMA step."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.datagen import GraphSet
from perfbench.reference import mace, optim
from repro_torch.core.mace import MaceConfig, init_mace, mace_energy_forces, weighted_loss
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.train.optimizer import EMA, adamw, apply_updates, chain, clip_by_global_norm

TCFG = {"lr": 5e-3, "weight_decay": 0.01, "clip_norm": 10.0, "ema_decay": 0.99,
        "energy_weight": 1.0, "forces_weight": 100.0, "max_graphs": 8}


def _configs(correlation):
    port = MaceConfig(n_species=10, channels=8, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
                      correlation=correlation, n_interactions=2, avg_num_neighbors=8.0,
                      impl="ref", interaction_impl="ref")
    fields = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    return port, mace.Config.from_fields(fields)


def _case(correlation, seed=5):
    port, ref = _configs(correlation)
    mols = GraphSet(5, seed, port.r_max, max_atoms=24).graphs
    params = mace.init_params(ref, seed, torch.device("cpu"))
    shape = BinShape.for_capacity(128, 48, TCFG["max_graphs"])
    batch = {k: torch.from_numpy(v) for k, v in collate_bin(mols, shape).items()}
    return port, ref, mols, params, batch


def test_parameter_layout_is_the_ports():
    for corr in (2, 3):
        port, ref = _configs(corr)
        want = {k: tuple(v.shape) for k, v in mace.flat_items(
            init_mace(port, torch.Generator().manual_seed(0)))}
        got = {k: shape for k, (shape, _) in mace.param_layout(ref).items()}
        assert got == want


@pytest.mark.parametrize("correlation", [2, 3])
def test_energy_and_forces_match_the_port(correlation):
    port, ref, mols, params, batch = _case(correlation)
    e_p, f_p = mace_energy_forces(params, port, batch, TCFG["max_graphs"])
    g = mace.batch_of(mols, torch.device("cpu"))
    e_r, f_r = mace.energy_forces(params, ref, g, len(mols), create_graph=False)
    n = len(mols)
    torch.testing.assert_close(e_r.detach(), e_p[:n], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(f_r, f_p[: g["species"].shape[0]], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("correlation", [2, 3])
def test_loss_gradients_and_one_update_match_the_port(correlation):
    port, ref, mols, params, batch = _case(correlation)
    flat0 = dict(mace.flat_items(params))
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat0.items()}
    loss_p, _ = weighted_loss(mace.nest(leaves), port, batch, TCFG["max_graphs"],
                              TCFG["energy_weight"], TCFG["forces_weight"])
    grads_p = dict(zip(leaves, torch.autograd.grad(loss_p, list(leaves.values()),
                                                   allow_unused=True)))
    grads_p = {k: torch.zeros_like(flat0[k]) if g is None else g for k, g in grads_p.items()}
    # two blocks, so the block-wise sum is exercised
    loss_r, grads_r = optim.bin_loss_and_grads(flat0, ref, mols, TCFG, torch.device("cpu"),
                                               block_atoms=40)
    assert loss_r == pytest.approx(float(loss_p.detach()), rel=2e-5)
    for k in flat0:
        torch.testing.assert_close(grads_r[k], grads_p[k], rtol=2e-4, atol=2e-6)

    tx = chain(clip_by_global_norm(TCFG["clip_norm"]),
               adamw(TCFG["lr"], weight_decay=TCFG["weight_decay"]))
    tree_g, tree_p = mace.nest(grads_p), mace.nest(flat0)
    upd, _ = tx.update(tree_g, tx.init(tree_p), tree_p, 0)
    new_p = apply_updates(tree_p, upd)
    ema_p = EMA(TCFG["ema_decay"]).update(EMA(TCFG["ema_decay"]).init(tree_p), new_p, 0)

    clipped = optim.clip(grads_p, TCFG["clip_norm"])
    state = {"m": {k: torch.zeros_like(v) for k, v in flat0.items()},
             "v": {k: torch.zeros_like(v) for k, v in flat0.items()}}
    new_r, _ = optim.adamw(flat0, clipped, state, 0, TCFG["lr"], TCFG["weight_decay"])
    ema_r = optim.ema(flat0, new_r, 0, TCFG["ema_decay"])
    for k, v in mace.flat_items(new_p):
        torch.testing.assert_close(new_r[k], v, rtol=1e-6, atol=1e-7)
    for k, v in mace.flat_items(ema_p):
        torch.testing.assert_close(ema_r[k], v, rtol=1e-6, atol=1e-7)
    assert np.isfinite(loss_r)
