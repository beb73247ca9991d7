"""Mixture-of-Experts FFN: top-k routing, capacity-bounded scatter/gather
dispatch, token-group streaming.

Port of the JAX package's ``models/moe.py``.  The dispatch is an integer
slot assignment (``token_for_slot [E, C]``) plus row gathers, not one-hot
einsums, so its cost is O(T*k*d); tokens stream through ``_moe_group`` in
sequence-chunk groups of about ``group_size`` tokens.

Top-k is the first ``k`` of a stable descending sort: ``jax.lax.top_k``
breaks ties toward the lower expert index, and ``torch.topk`` promises no
order among ties.

``set_ep_sharding`` is the JAX module's expert-parallel constraint: where
the dispatched tokens ``xe``, the expert outputs ``ye`` and the expert
weights are DTensors, they are redistributed to the given placements (on
plain tensors nothing changes).  Where the experts do not split evenly
over the mesh dims the placements shard them over (8 experts, 16 'model'
ranks), ``xe`` and the weights are padded with zero experts up to the next
multiple, as GSPMD pads: no token is routed to them, but their shards are
held and computed.

The groups run through ``loops.scan``: on the dry run's meta DTensors it
traces three of a layer's 512 groups and scales the rest.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from . import loops
from .layers import make_dense, normal

Params = Dict[str, torch.Tensor]

# Optional expert-parallel constraint on the dispatched/expert-side tensors
# (set by the launcher): pins xe/ye (and the expert weights) to 'model'-on-E
# placements, so the token(dp) <-> expert(model) boundary is one reshard
# instead of repeated gathers.
_EP_SHARDING = None
_MOE_WEIGHT_SHARDING = None


def set_ep_sharding(ep, weight=None) -> None:
    """Placements of ``xe``/``ye`` and of the expert weights, or ``None``."""
    global _EP_SHARDING, _MOE_WEIGHT_SHARDING
    _EP_SHARDING = None if ep is None else tuple(ep)
    _MOE_WEIGHT_SHARDING = None if weight is None else tuple(weight)


def _redistribute(t, placements):
    if placements is not None and isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, placements)
    return t


def _ep_constrain(t):
    return _redistribute(t, _EP_SHARDING)


def _weight_constrain(w):
    """Pin the layer's expert weights to their 'model'-on-E placements:
    their FSDP dim is gathered once per layer, not once per token group."""
    return _redistribute(w, _MOE_WEIGHT_SHARDING)


def _ep_pad(t):
    """``t`` (experts first) padded with zero experts to a multiple of the
    ranks the EP placements split them over (DTensors only)."""
    if _EP_SHARDING is None or not isinstance(t, DTensor):
        return t
    n = 1
    for size, p in zip(t.device_mesh.shape, _EP_SHARDING):
        if p.is_shard(0):
            n *= size
    extra = -t.shape[0] % n
    if not extra:
        return t
    return torch.cat([t, torch.zeros((extra,) + tuple(t.shape[1:]), dtype=t.dtype,
                                     device=t.device)], dim=0)


def _gather_rows(table, idx):
    """``table[idx]``.  On DTensors the table is gathered whole, as
    DTensor's own indexing gathers it, and each rank takes its rows from it
    locally: the backward of DTensor's indexing, an ``index_put``, found no
    valid sharding for the gradients of the dispatch and the combine in
    torch 2.11 (an unnormalized ``Shard(-1)``)."""
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
        out = loops.run_local(None, lambda t, i: (t[i],), (table, idx), (("r", "d"), ("t", "k")),
                              (("t", "k", "d"),), ("t",))
        if out is not None:
            return out[0]
    return table[idx]


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> Params:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    return {
        "router": make_dense(gen, d, E, dtype, device),
        "wi": normal(gen, (E, d, f), dtype, device) * s,
        "wg": normal(gen, (E, d, f), dtype, device) * s,
        "wo": normal(gen, (E, f, d), dtype, device) * (1.0 / math.sqrt(f)),
    }


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, Tg: int, capacity_factor: float) -> int:
    """Slots per expert for a group of ``Tg`` tokens: a multiple of 4, at
    least 4."""
    C = int(math.ceil(capacity_factor * cfg.top_k * Tg / cfg.n_experts))
    return max(4, -(-C // 4) * 4)


def _moe_group(p: Params, cfg, xt: torch.Tensor, capacity_factor: float):
    """One token group.  xt: [Tg, d] -> (y [Tg, d], aux scalar)."""
    Tg, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k

    logits = (xt @ p["router"]).to(torch.float32)             # [Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                     # [Tg, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    C = capacity(cfg, Tg, capacity_factor)

    # position of each (token, choice) in its expert queue
    sel = (gate_idx[..., None] == torch.arange(E, device=xt.device)).to(torch.int32)  # [Tg, k, E]
    pos = torch.cumsum(sel.reshape(Tg * k, E), dim=0).reshape(Tg, k, E) - sel
    pos = (pos * sel).sum(-1)                                  # [Tg, k]
    fits = pos < C
    gate_vals = gate_vals * fits

    # slot assignment: token_for_slot[e, c] = source token (Tg = empty);
    # dropped choices land in column C, which is then cut
    flat_e = gate_idx.reshape(-1)
    flat_c = torch.where(fits, pos, C).reshape(-1)
    flat_t = torch.arange(Tg, device=xt.device)[:, None].expand(Tg, k).reshape(-1)
    token_for_slot = torch.full((E, C + 1), Tg, dtype=torch.long, device=xt.device)
    token_for_slot = token_for_slot.index_put((flat_e, flat_c.long()), flat_t)
    token_for_slot = token_for_slot[:, :C]                    # [E, C]

    # dispatch: gather token rows (the padding row Tg is zeros)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = _ep_constrain(_ep_pad(_gather_rows(xt_pad, token_for_slot)))   # [E, C, d]
    wg = _weight_constrain(_ep_pad(p["wg"]))
    wi = _weight_constrain(_ep_pad(p["wi"]))
    wo = _weight_constrain(_ep_pad(p["wo"]))
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, wg)) * torch.einsum("ecd,edf->ecf", xe, wi)
    ye = _ep_constrain(torch.einsum("ecf,efd->ecd", h, wo))  # [E, C, d]

    # combine: each token gathers its k slots back (padded experts last)
    ye_flat = ye.reshape(-1, d)
    gather_idx = torch.where(fits, gate_idx * C + torch.clamp(pos, max=C - 1), 0)
    yk = _gather_rows(ye_flat, gather_idx)                    # [Tg, k, d]
    y = torch.einsum("tkd,tk->td", yk, gate_vals.to(xt.dtype) * fits)

    # Switch-style load-balance aux
    me = probs.mean(0)
    ce = sel.to(torch.float32).sum(1).mean(0)
    aux = E * torch.sum(me * ce)
    return y, aux.to(xt.dtype)


def apply_moe(
    p: Params, cfg, x: torch.Tensor, *,
    capacity_factor: float = 1.25, group_size: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux).  Streams sequence-chunk groups
    ``[n_chunks, B * chunk_s, d]`` (B-major inside a group) through
    ``_moe_group``; aux is the groups' mean."""
    B, S, d = x.shape
    T = B * S
    if T <= group_size or S == 1:
        y, aux = _moe_group(p, cfg, x.reshape(T, d), capacity_factor)
        return y.reshape(B, S, d), aux

    chunk_s = max(1, group_size // B)
    while S % chunk_s != 0:
        chunk_s -= 1
    n_chunks = S // chunk_s
    g = B * chunk_s
    xs = x.reshape(B, n_chunks, chunk_s, d).transpose(0, 1).reshape(n_chunks, g, d)
    names = ("router", "wi", "wg", "wo")

    def group(carry, xc, weights):
        yg, a = _moe_group(dict(zip(names, weights)), cfg, xc[0], capacity_factor)
        return carry, (yg, a)

    _, (ys, auxs) = loops.scan("moe_groups", group, n_chunks, (), (xs,),
                               tuple(p[k] for k in names))
    aux = x.new_zeros(())
    if isinstance(auxs, DTensor):
        aux = aux + auxs.sum()
    else:
        for a in auxs.unbind(0):      # the groups' order, as the reference sums them
            aux = aux + a
    aux = aux / n_chunks
    y = ys.reshape(n_chunks, B, chunk_s, d).transpose(0, 1).reshape(B, S, d)
    return y, aux
