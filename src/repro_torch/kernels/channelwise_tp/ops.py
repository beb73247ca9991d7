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

The op is a ``torch.autograd.Function`` that saves only its own inputs
(with ``receivers`` and ``edge_mask``, which the blocking arrays encode but
the second-order rule reads).  Its backward is itself an
``autograd.Function`` (:class:`_BlockedInteractionBwd`, the JAX package's
``_blocked_bwd_op``) whose derivative is the double VJP of the plain twin
``core.interaction.interaction_fused`` over the unblocked arrays, taken in
chunks of edges (exact: the op is a sum over edges) so that its
``[E, k, nnz]`` intermediates stay a fixed size.  First order runs the
hand-written kernels; only the derivative *of* the backward goes through
the twin.  The unblocked (TP-only) path and the TP-only op wait for a
later slice: ``blocking=None`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.interaction import InteractionSpec, interaction_fused
from repro_torch.kernels import refuse_third_order

from .kernel import tp_gather_bwd, tp_scatter

# edges per chunk of the second-order rule: its autodiff keeps about a dozen
# [chunk, k, nnz] fp32 tensors live, 4.3 GB at k = 128 and nnz = 86 (the
# paper's layer 1), where the 147,456 edges of a 3,072-atom bin at once
# would need 78 GB
TWIN_CHUNK_EDGES = 8192


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


def _twin_second_order(spec, g, Y, h_node, R, senders, receivers, edge_mask,
                       ddY, ddh, ddR):
    """d/d(g, Y, h_node, R) of ``<(ddY, ddh, ddR), VJP of interaction_fused
    at (Y, h_node, R) with g>``, one chunk of edges at a time: the chunk's
    share of the op is ``interaction_fused`` over its edges, whose VJP gives
    that chunk's rows of dY and dR and its part of dh."""
    E = Y.shape[0]
    dg, dh = torch.zeros_like(g), torch.zeros_like(h_node)
    dY, dR = torch.empty_like(Y), torch.empty_like(R)
    for lo in range(0, E, TWIN_CHUNK_EDGES):
        sl = slice(lo, min(lo + TWIN_CHUNK_EDGES, E))
        with torch.enable_grad():
            gg, y, h, r = (t.detach().requires_grad_(True)
                           for t in (g, Y[sl], h_node, R[sl]))
            A = interaction_fused(y, h, r, senders[sl], receivers[sl],
                                  edge_mask[sl], spec=spec)
            first = torch.autograd.grad(A, (y, h, r), gg, create_graph=True)
            parts = torch.autograd.grad(first, (gg, y, h, r),
                                        (ddY[sl], ddh, ddR[sl]), allow_unused=True)
        pg, py, ph, pr = (torch.zeros_like(t) if p is None else p
                          for p, t in zip(parts, (gg, y, h, r)))
        dg += pg
        dh += ph
        dY[sl] = py
        dR[sl] = pr
    return dg, dY, dh, dR


class _BlockedInteractionBwd(torch.autograd.Function):
    """``(g [N, k, d_out], Y, h_node, R, ...) -> (dY, dh_node, dR)``: the
    gather + TP-transpose kernel between the adjoints of the forward's
    host-side gathers; its own derivative is :func:`_twin_second_order`."""

    @staticmethod
    def forward(ctx, g, Y, h_node, R, senders, receivers, edge_mask, perm,
                valid, local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(g, Y, h_node, R, senders, receivers, edge_mask)
        n_atoms = h_node.shape[0]
        send_b, Y_b, h_b, R_b = _slot_operands(Y, h_node, R, senders, perm)
        # adjoint of (transpose -> /avg -> fold over tile rows): gather the
        # per-atom cotangent into tile layout (trash rows read zeros)
        gt = g.transpose(1, 2) / spec.avg_num_neighbors      # [N, d_out, k]
        gpad = torch.cat([gt, gt.new_zeros((spec.block_n,) + gt.shape[1:])])
        G_t = gpad[_tile_rows(base, spec.block_n)].contiguous()
        dY_b, dh_b, dR_b = tp_gather_bwd(
            G_t, Y_b, h_b, R_b, local, valid, spec.tp,
            n_tiles=base.shape[0], block_n=spec.block_n,
        )
        # un-permute: valid slots are a permutation of the valid edges and
        # masked slots carry exact zeros, so padding slots add zeros to edge 0
        dY = torch.zeros_like(Y).index_add_(0, perm, dY_b)
        dR = torch.zeros_like(R).index_add_(0, perm, dR_b)
        dh = dh_b.new_zeros((n_atoms,) + dh_b.shape[1:]).index_add_(0, send_b, dh_b)
        return dY, dh.transpose(1, 2), dR

    @staticmethod
    def backward(ctx, ddY, ddh, ddR):
        refuse_third_order("interaction backward")
        grads = _twin_second_order(ctx.spec, *ctx.saved_tensors, ddY, ddh, ddR)
        return (*grads, None, None, None, None, None, None, None, None)


class _BlockedInteraction(torch.autograd.Function):
    """``(Y [E, d_sh], h_node [N, k, d_h], R [E, n_paths, k]) -> A [N, k,
    d_out]`` over pre-blocked edges."""

    @staticmethod
    def forward(ctx, Y, h_node, R, senders, receivers, edge_mask, perm, valid,
                local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(Y, h_node, R, senders, receivers, edge_mask,
                              perm, valid, local, base)
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
    def backward(ctx, g):
        dY, dh, dR = _BlockedInteractionBwd.apply(
            g.contiguous(), *ctx.saved_tensors, ctx.spec)
        return (dY, dh, dR) + (None,) * 8


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

    The kernels read the blocking arrays, which encode ``receivers`` and
    ``edge_mask``; the op keeps both for its second-order rule."""
    if blocking is None:
        raise ValueError(
            "interaction/cuda needs the blk_* edge blocking in the batch: the "
            "unblocked path is not ported"
        )
    perm, base = blocking["perm"], blocking["base"]
    if perm.shape[0] % base.shape[0]:
        raise ValueError("blocking perm length not a multiple of tile count")
    return _BlockedInteraction.apply(
        Y, h_node, R, senders, receivers, edge_mask, perm, blocking["valid"],
        blocking["local"].to(torch.int32).contiguous(), base, spec,
    )
