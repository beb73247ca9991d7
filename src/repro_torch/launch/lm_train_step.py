"""LM train step: value-and-grad + AdamW, with a micro-batch option.

Port of the JAX package's ``launch/lm_train_step.py`` (its single-device
step; ``make_lm_train_step_ddp`` and ``opt_state_specs`` belong to the
multi-device half of the port).  ``micro_batches > 1`` splits the batch
along B and accumulates float32 gradients over the slices, each divided by
the count, as the JAX scan does: the activation peak shrinks by the factor,
at the cost of one gradients-sized buffer.

The optimizer is the port's ``train/optimizer.py::adamw(lr,
weight_decay=0.1)``, applied one parameter at a time (the same elementwise
algebra as one call over the whole tree, without its whole-tree
temporaries: at 2.6 B parameters those alone would not fit the card).
Parameters are updated in place; ``m`` and ``v`` are dicts keyed by the
model's parameter names (:func:`init_opt_state`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models.model import LM, ArchConfig, forward_train
from repro_torch.train.optimizer import adamw


def init_opt_state(params: LM) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Zero float32 ``m`` and ``v`` per parameter."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    return zeros, {n: torch.zeros_like(z) for n, z in zeros.items()}


def _value_and_grad(params: LM, cfg: ArchConfig, batch):
    named = list(params.named_parameters())
    loss, _ = forward_train(params, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named, grads)}


def lm_value_and_grad(params: LM, cfg: ArchConfig, batch: Mapping[str, torch.Tensor],
                      micro_batches: int = 1):
    """(loss, {name: gradient}); with ``micro_batches > 1`` the mean over
    the batch's slices, gradients accumulated in float32."""
    if micro_batches == 1:
        return _value_and_grad(params, cfg, batch)
    B = batch["tokens"].shape[0]
    if B % micro_batches:
        raise ValueError(f"batch {B} does not split into {micro_batches} micro-batches")
    mb = B // micro_batches
    loss_acc = torch.zeros((), dtype=torch.float32, device=params.embed.device)
    gacc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
    for i in range(micro_batches):
        micro = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
        loss, grads = _value_and_grad(params, cfg, micro)
        for n, g in grads.items():
            gacc[n] = gacc[n] + g.to(torch.float32) / micro_batches
        loss_acc = loss_acc + loss / micro_batches
    return loss_acc, gacc


def make_lm_train_step(cfg: ArchConfig, lr: float = 3e-4, micro_batches: int = 1):
    """``step(params, m, v, batch, step_idx) -> (params, m, v, loss,
    grad_norm)``: the JAX step's four results and the gradient's global
    L2 norm (a float32 device scalar, before the update)."""
    opt = adamw(lr, weight_decay=0.1)

    def step(params: LM, m, v, batch, step_idx):
        loss, grads = lm_value_and_grad(params, cfg, batch, micro_batches)
        dev = params.embed.device
        t = torch.as_tensor(step_idx, device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for name, p in params.named_parameters():
                g = grads.pop(name)
                sq = sq + torch.sum(g.to(torch.float32) ** 2)
                upd, st = opt.update({name: g}, {"m": {name: m[name]}, "v": {name: v[name]}},
                                     {name: p}, t)
                m[name], v[name] = st["m"][name], st["v"][name]
                p.add_(upd[name])
        return params, m, v, loss, torch.sqrt(sq)

    return step
