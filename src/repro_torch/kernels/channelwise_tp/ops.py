"""Public wrapper for the fused TP+scatter interaction kernels: the port of
the blocked path of the JAX package's ``kernels/channelwise_tp/ops.py``
(``_blocked_forward``, ``_blocked_bwd_op``, ``_make_pallas_interaction_op``).

Batch contract: edge blocking is a data-pipeline product
(``data.blocking.block_edges``); its arrays ride inside the batch under the
``blk_*`` keys and reach :func:`interaction_cuda_op` as ``blocking``.

Forward (all plain torch around the kernel, as it is XLA around the kernel
in JAX): gather ``Y[perm]``, ``h[senders[perm]]`` and ``R[perm]`` into slot
layout, run the TP+scatter kernel into ``[T * block_n]`` tile rows, fold
the virtual tiles onto atom rows with ``index_add_`` at ``base + row``
(bases repeat for hub atoms; padding tiles point at the trash rows
``n_atoms..n_atoms + block_n``, which are sliced off), divide by
``avg_num_neighbors``.

Backward: the adjoint of the fold is a gather of cotangent rows into tile
layout (trash rows read zeros), then the gather + TP-transpose kernel, then
the adjoints of the host-side gathers: an un-permuting ``index_add_`` over
``perm`` (masked slots carry exact zeros, so padding slots only add zeros
to edge 0) and a segment-sum of ``dh`` over senders.

The op is a ``torch.autograd.Function`` that saves only its own inputs; its
backward is ``once_differentiable``, so a grad-of-grad raises until the
training slice adds the second-order twin.  The unblocked (TP-only) path
and the TP-only op wait for a later slice: ``blocking=None`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.interaction import InteractionSpec

from .kernel import tp_gather_bwd, tp_scatter


def _tile_rows(base: torch.Tensor, block_n: int) -> torch.Tensor:
    """[T * block_n] atom row per tile row."""
    offs = torch.arange(block_n, dtype=torch.long, device=base.device)
    return (base.long()[:, None] + offs).reshape(-1)


def _slot_operands(Y, h_node, R, senders, perm):
    send_b = senders[perm]
    Y_b = Y[perm].contiguous()                               # [E_p, d_sh]
    h_b = h_node[send_b].transpose(1, 2).contiguous()        # [E_p, d_h, k]
    R_b = R[perm].contiguous()                               # [E_p, n_paths, k]
    return send_b, Y_b, h_b, R_b


class _BlockedInteraction(torch.autograd.Function):
    """``(Y [E, d_sh], h_node [N, k, d_h], R [E, n_paths, k]) -> A [N, k,
    d_out]`` over pre-blocked edges."""

    @staticmethod
    def forward(ctx, Y, h_node, R, senders, perm, valid, local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(Y, h_node, R, senders, perm, valid, local, base)
        n_atoms = h_node.shape[0]
        _, Y_b, h_b, R_b = _slot_operands(Y, h_node, R, senders, perm)
        A_t = tp_scatter(
            Y_b, h_b, R_b, local, valid, spec.tp,
            n_tiles=base.shape[0], block_n=spec.block_n,
        )                                                    # [T*block_n, d_out, k]
        A = A_t.new_zeros((n_atoms + spec.block_n,) + A_t.shape[1:])
        A.index_add_(0, _tile_rows(base, spec.block_n), A_t)
        return A[:n_atoms].transpose(1, 2) / spec.avg_num_neighbors

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        Y, h_node, R, senders, perm, valid, local, base = ctx.saved_tensors
        spec = ctx.spec
        n_atoms = h_node.shape[0]
        send_b, Y_b, h_b, R_b = _slot_operands(Y, h_node, R, senders, perm)
        gt = g.transpose(1, 2) / spec.avg_num_neighbors      # [N, d_out, k]
        gpad = torch.cat([gt, gt.new_zeros((spec.block_n,) + gt.shape[1:])])
        G_t = gpad[_tile_rows(base, spec.block_n)].contiguous()
        dY_b, dh_b, dR_b = tp_gather_bwd(
            G_t, Y_b, h_b, R_b, local, valid, spec.tp,
            n_tiles=base.shape[0], block_n=spec.block_n,
        )
        dY = torch.zeros_like(Y).index_add_(0, perm, dY_b)
        dR = torch.zeros_like(R).index_add_(0, perm, dR_b)
        dh = dh_b.new_zeros((n_atoms,) + dh_b.shape[1:]).index_add_(0, send_b, dh_b)
        return dY, dh.transpose(1, 2), dR, None, None, None, None, None, None


def interaction_cuda_op(
    Y: torch.Tensor,
    h_node: torch.Tensor,
    R: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    spec: InteractionSpec,
    blocking: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Registered ``interaction/cuda`` impl: A [N, k, d_out] (already /avg).

    ``receivers``/``edge_mask`` are unused (the blocking arrays encode both)
    but kept in the uniform interaction signature."""
    del receivers, edge_mask
    if blocking is None:
        raise ValueError(
            "interaction/cuda needs the blk_* edge blocking in the batch: the "
            "unblocked path is not ported"
        )
    perm, base = blocking["perm"], blocking["base"]
    if perm.shape[0] % base.shape[0]:
        raise ValueError("blocking perm length not a multiple of tile count")
    return _BlockedInteraction.apply(
        Y, h_node, R, senders, perm, blocking["valid"],
        blocking["local"].to(torch.int32).contiguous(), base, spec,
    )
