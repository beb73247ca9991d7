"""The benchmark's plain reference at l = 2 hidden features: MACE-MP-0
large's ``REDUCED`` (8 channels; hidden irreps 0e+1o+2e, A irreps up to l
= 3, correlation 3) on seeded weights, against the port's path on the CPU
(its ``cuda`` impls, whose CPU path is the plain versions the kernels are
held to), with ``test_perfbench_reference.py``'s tolerances; and the
reference alone under a random rotation, which checks its l = 2 tables
without the port."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.datagen import GraphSet
from perfbench.reference import mace, optim
from repro_torch.configs.mace_mp0_large import REDUCED
from repro_torch.core.mace import mace_energy_forces, weighted_loss
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.train.optimizer import EMA, adamw, apply_updates, chain, clip_by_global_norm

TCFG = {"lr": 5e-3, "weight_decay": 0.01, "clip_norm": 10.0, "ema_decay": 0.99,
        "energy_weight": 1.0, "forces_weight": 100.0, "max_graphs": 8}
CPU = torch.device("cpu")


def _case(seed=7, n_graphs=4, max_atoms=16):
    fields = {f.name: getattr(REDUCED, f.name) for f in dataclasses.fields(REDUCED)}
    ref = mace.Config.from_fields(fields)
    mols = GraphSet(n_graphs, seed, REDUCED.r_max, max_atoms=max_atoms).graphs
    params = mace.init_params(ref, seed, CPU)
    shape = BinShape.for_capacity(64, 48, TCFG["max_graphs"])
    batch = {k: torch.from_numpy(v) for k, v in collate_bin(mols, shape).items()}
    return ref, mols, params, batch


def test_the_reduced_config_keeps_every_order_of_the_published_one():
    assert (REDUCED.hidden_ls, REDUCED.a_ls, REDUCED.sh_lmax, REDUCED.correlation) == \
        ((0, 1, 2), (0, 1, 2, 3), 3, 3)
    assert REDUCED.symcon_spec().out_spec.dim == 9


def test_energy_and_forces_match_the_port():
    ref, mols, params, batch = _case()
    e_p, f_p = mace_energy_forces(params, REDUCED, batch, TCFG["max_graphs"])
    g = mace.batch_of(mols, CPU)
    e_r, f_r = mace.energy_forces(params, ref, g, len(mols), create_graph=False)
    torch.testing.assert_close(e_r.detach(), e_p[:len(mols)], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(f_r, f_p[: g["species"].shape[0]], rtol=2e-5, atol=2e-5)


def test_loss_gradients_and_one_update_match_the_port():
    ref, mols, params, batch = _case(seed=11)
    flat0 = dict(mace.flat_items(params))
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat0.items()}
    loss_p, _ = weighted_loss(mace.nest(leaves), REDUCED, batch, TCFG["max_graphs"],
                              TCFG["energy_weight"], TCFG["forces_weight"])
    grads_p = dict(zip(leaves, torch.autograd.grad(loss_p, list(leaves.values()),
                                                   allow_unused=True)))
    grads_p = {k: torch.zeros_like(flat0[k]) if g is None else g for k, g in grads_p.items()}
    # two blocks, so the block-wise sum is exercised
    loss_r, grads_r = optim.bin_loss_and_grads(flat0, ref, mols, TCFG, CPU, block_atoms=30)
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


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return torch.from_numpy((q * np.sign(np.linalg.det(q))).astype(np.float32))


def test_reference_energies_are_invariant_and_forces_rotate():
    """Rotate every graph's positions by one proper rotation R: the edges
    stay (distances keep), energies keep and forces turn by R, to 1e-5."""
    ref, mols, params, _ = _case(seed=13)
    g = mace.batch_of(mols, CPU)
    R = _rotation(13)
    turned = dict(g, positions=g["positions"] @ R.T)
    e, f = mace.energy_forces(params, ref, g, len(mols), create_graph=False)
    e_rot, f_rot = mace.energy_forces(params, ref, turned, len(mols), create_graph=False)
    assert float(f.abs().max()) > 1e-3  # the forces are not trivially 0
    torch.testing.assert_close(e_rot.detach(), e.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f_rot, f @ R.T, rtol=1e-5, atol=1e-5)
