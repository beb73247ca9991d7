"""The reference's training step: the weighted loss of one bin and its
parameter gradients, taken graph block by graph block, then global-norm
clipping, AdamW and the EMA, in plain float32 over flat dicts of tensors.

The loss is the port's (paper §5.2): ``energy_weight`` times the mean over
the bin's ``max_graphs`` graph slots of the squared per-atom energy error
(slots without a graph add 0), plus ``forces_weight`` times the mean over
the bin's real atoms and the three components of the squared force error.
Both terms are sums over graphs, so a bin's gradient is the sum of its
blocks' gradients with the bin's normalisers.  AdamW: ``t = step + 1``, bias
corrections ``1 - b**t``, ``eps`` outside the square root.  EMA: decay
``min(decay, (1 + step) / (10 + step))``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import mace

Flat = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8


def bin_loss_and_grads(flat: Flat, cfg: mace.Config, mols, tcfg: Dict,
                       device, block_atoms: int) -> Tuple[float, Flat]:
    """(loss, gradients) of one bin of graphs ``mols``."""
    keys = list(flat)
    leaves = [flat[k].detach().requires_grad_(True) for k in keys]
    params = mace.nest(dict(zip(keys, leaves)))
    n_at = max(float(sum(m.n_atoms for m in mols)), 1.0)
    n_g = float(tcfg["max_graphs"])
    loss = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for block in mace.blocks_of(mols, block_atoms):
        g = mace.batch_of(block, device)
        e, f = mace.energy_forces(params, cfg, g, len(block), create_graph=True)
        e_err = ((e - g["energy"]) / torch.clamp(g["n_atoms"], min=1.0)) ** 2
        f_err = torch.sum((f - g["forces"]) ** 2)
        part = (tcfg["energy_weight"] * torch.sum(e_err) / n_g
                + tcfg["forces_weight"] * f_err / (3.0 * n_at))
        got = torch.autograd.grad(part, leaves, allow_unused=True)
        grads = [a if b is None else a + b for a, b in zip(grads, got)]
        loss += float(part.detach())
    return loss, dict(zip(keys, grads))


@torch.no_grad()
def clip(grads: Flat, max_norm: float) -> Flat:
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def adamw(params: Flat, grads: Flat, state: Dict[str, Flat], step: int, lr: float,
          weight_decay: float) -> Tuple[Flat, Dict[str, Flat]]:
    t = step + 1.0
    m = {k: B1 * state["m"][k] + (1 - B1) * g for k, g in grads.items()}
    v = {k: B2 * state["v"][k] + (1 - B2) * g * g for k, g in grads.items()}
    new = {k: p - lr * ((m[k] / (1 - B1 ** t)) / (torch.sqrt(v[k] / (1 - B2 ** t)) + EPS)
                        + weight_decay * p)
           for k, p in params.items()}
    return new, {"m": m, "v": v}


@torch.no_grad()
def ema(avg: Flat, params: Flat, step: int, decay: float) -> Flat:
    d = min(decay, (1.0 + step) / (10.0 + step))
    return {k: d * avg[k] + (1 - d) * p for k, p in params.items()}


def train_steps(flat0: Flat, cfg: mace.Config, bins: List[list], tcfg: Dict, device,
                block_atoms: int) -> Dict[str, object]:
    """The reference run of the first ``len(bins)`` steps from ``flat0``:
    each step's loss, the first step's clipped gradient, the parameters and
    the EMA after the last step."""
    params = dict(flat0)
    state = {"m": {k: torch.zeros_like(p) for k, p in params.items()},
             "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    avg = {k: p.clone() for k, p in params.items()}
    losses, first_grad = [], None
    for step, mols in enumerate(bins):
        loss, grads = bin_loss_and_grads(params, cfg, mols, tcfg, device, block_atoms)
        grads = clip(grads, tcfg["clip_norm"])
        if first_grad is None:
            first_grad = grads
        params, state = adamw(params, grads, state, step, tcfg["lr"], tcfg["weight_decay"])
        avg = ema(avg, params, step, tcfg["ema_decay"])
        losses.append(loss)
    return {"losses": losses, "grad": first_grad, "params": params, "ema": avg}
