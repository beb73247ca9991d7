"""LM train step: value-and-grad + AdamW, with a micro-batch option, on one
device, sharded, or data-parallel.

Port of the JAX package's ``launch/lm_train_step.py``.  ``micro_batches >
1`` splits the batch along B and accumulates float32 gradients over the
slices, each divided by the count, as the JAX scan does: the activation
peak shrinks by the factor, at the cost of one gradients-sized buffer.

:func:`make_lm_train_step` also runs sharded: on parameters placed as
DTensors by ``launch/sharding.py`` (the JAX step jitted on sharded
inputs), it runs under ``implicit_replication`` (the plain tensors the
model makes, positions, masks and rope tables, join as replicated), and
``m`` and ``v`` from :func:`init_opt_state` carry the parameters'
placements.  :func:`make_lm_train_step_ddp` is the JAX manual-DP
(``shard_map``) step on ``torch.distributed``, one process per rank.

The optimizer is the port's ``train/optimizer.py::adamw(lr,
weight_decay=0.1)``, applied one parameter at a time (the same elementwise
algebra as one call over the whole tree, without its whole-tree
temporaries: at 2.6 B parameters those alone would not fit the card).
Parameters are updated in place; ``m`` and ``v`` are dicts keyed by the
model's parameter names (:func:`init_opt_state`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.model import LM, ArchConfig, forward_train
from repro_torch.train.compression import all_reduce_, compressed_allreduce
from repro_torch.train.engine import flat_mean
from repro_torch.train.optimizer import adamw

_LOSS = "<loss>"  # the loss's key in the flat buffer: no parameter name has '<'


def init_opt_state(params: LM) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Zero float32 ``m`` and ``v`` per parameter, on its device and, for a
    DTensor parameter, with its placements."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
             for n, p in params.named_parameters()}
    return zeros, {n: torch.zeros_like(z) for n, z in zeros.items()}


def opt_state_specs(param_specs: LM):
    """``(m, v)`` of a meta ``LM`` (``launch/shapes.py::lm_param_specs``):
    float32 meta twins of its parameters."""
    return init_opt_state(param_specs)


def _replicating(params: LM):
    """``implicit_replication`` where the parameters are DTensors: the
    plain tensors the model makes (positions, masks, rope tables, the step
    count) then join as replicated."""
    if isinstance(params.embed, DTensor):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


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
    gacc = {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.named_parameters()}
    for i in range(micro_batches):
        micro = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
        loss, grads = _value_and_grad(params, cfg, micro)
        for n, g in grads.items():
            gacc[n] = gacc[n] + g.to(torch.float32) / micro_batches
        loss_acc = loss_acc + loss / micro_batches
    return loss_acc, gacc


def _adamw_in_place(opt, params: LM, m, v, grads, step_idx) -> torch.Tensor:
    """One AdamW update of every parameter, in place; returns the
    gradients' global L2 norm (before the update)."""
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
    return torch.sqrt(sq)


def make_lm_train_step(cfg: ArchConfig, lr: float = 3e-4, micro_batches: int = 1):
    """``step(params, m, v, batch, step_idx) -> (params, m, v, loss,
    grad_norm)``: the JAX step's four results and the gradient's global
    L2 norm (a float32 device scalar, before the update).  On DTensor
    parameters every tensor it returns is a DTensor too."""
    opt = adamw(lr, weight_decay=0.1)

    def step(params: LM, m, v, batch, step_idx):
        with _replicating(params):
            loss, grads = lm_value_and_grad(params, cfg, batch, micro_batches)
            gnorm = _adamw_in_place(opt, params, m, v, grads, step_idx)
        return params, m, v, loss, gnorm

    return step


# --------------------------- data parallel ----------------------------------


def rank_rows(batch: Mapping[str, torch.Tensor], rank: int, n_ranks: int):
    """Rank ``rank``'s rows ``[rank·B/R, (rank+1)·B/R)`` of every batch
    entry: the block ``PartitionSpec(dp)`` gives that rank."""
    B = batch["tokens"].shape[0]
    if B % n_ranks:
        raise ValueError(f"batch {B} does not split over {n_ranks} ranks")
    b = B // n_ranks
    return {k: t[rank * b:(rank + 1) * b] for k, t in batch.items()}


def stacked_groups(cfg: ArchConfig, names) -> List[List[str]]:
    """The parameter names grouped as the JAX tree stacks them: one group
    per top-level parameter, one per (segment, position in the group,
    parameter) holding that parameter of each of the segment's repeats, in
    repeat order.  A quantised average keeps one scale per group, as the
    JAX ``compressed_psum`` keeps one per stacked leaf."""
    where = {}
    layer = 0
    for si, (plen, reps) in enumerate(cfg.segments):
        for r in range(reps):
            for pos in range(plen):
                where[layer] = (si, pos)
                layer += 1
    groups: Dict[Tuple, List[str]] = {}
    for n in names:
        if n.startswith("layers."):
            _, i, rest = n.split(".", 2)
            key = where[int(i)] + (rest,)
        else:
            key = (n,)
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def average_gradients(cfg: ArchConfig, grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                      group=None, compress: bool = False):
    """The mean over ``group``'s ranks of every gradient (float32) and of
    the loss.  Plain: the engines' ``flat_mean`` of one flat float32
    buffer (the gradients, then the loss; with one rank it is that buffer,
    and no collective is issued).  ``compress``: the port's
    ``compressed_allreduce`` (int8 payloads, one shared scale per
    :func:`stacked_groups` group) and a plain mean of the loss.  A CUDA
    tensor over gloo is staged through host memory (``all_reduce_``)."""
    R = dist.get_world_size(group)
    names = list(grads)
    if compress:
        groups = stacked_groups(cfg, names)
        means = compressed_allreduce(
            [torch.stack([grads[n].to(torch.float32) for n in g]) for g in groups], group)
        out = {n: t for g, mean in zip(groups, means) for n, t in zip(g, mean.unbind(0))}
        lbuf = loss.to(torch.float32).reshape(1)
        all_reduce_(lbuf, dist.ReduceOp.SUM, group)
        return out, (lbuf / R)[0]
    flat = {n: grads[n].to(torch.float32) for n in names}
    flat[_LOSS] = loss.to(torch.float32)
    out = flat_mean(flat, group, R)
    return out, out.pop(_LOSS)


def make_lm_train_step_ddp(cfg: ArchConfig, group=None, lr: float = 3e-4,
                           compress: bool = False):
    """Manual-DP train step for small recurrent models: the JAX
    ``shard_map`` step, one process per rank of ``group`` (default: the
    world).

    Every rank holds the whole model, ``m`` and ``v`` and is given the
    whole batch; it takes its rows (:func:`rank_rows`), runs value-and-grad
    on them, and the gradients are averaged exactly once after the backward
    (:func:`average_gradients`), then the same per-parameter AdamW as
    :func:`make_lm_train_step`.  Under GSPMD auto-partitioning the gradient
    of a weight closed over by a per-timestep loop (the sLSTM recurrent
    matrix) would be reduced every timestep; here it is reduced once, the
    DDP schedule.  ``compress=True`` sends int8 payloads (no error
    feedback: the quantisation noise is the documented trade-off).  Returns
    ``step(params, m, v, batch, step_idx) -> (params, m, v, loss,
    grad_norm)`` with the loss averaged over the ranks."""
    opt = adamw(lr, weight_decay=0.1)

    def step(params: LM, m, v, batch, step_idx):
        local = rank_rows(batch, dist.get_rank(group), dist.get_world_size(group))
        loss, grads = lm_value_and_grad(params, cfg, local)
        with torch.no_grad():
            grads, loss = average_gradients(cfg, grads, loss, group, compress)
        gnorm = _adamw_in_place(opt, params, m, v, grads, step_idx)
        return params, m, v, loss, gnorm

    return step
