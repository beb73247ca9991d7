"""Public wrappers for the interaction kernels: the port of the JAX package's
``kernels/channelwise_tp/ops.py``.

Batch contract: edge blocking is a data-pipeline product
(``data.blocking.block_edges``); its arrays ride inside the batch under the
``blk_*`` keys and reach :func:`interaction_cuda_op` as ``blocking``.

One autograd route, the blocked op (:class:`_Interaction`).  Forward (plain
torch around the kernel, as it is XLA around the kernel in JAX): gather
``Y[perm]``, ``h[senders[perm]]`` and ``R[perm]`` into slot layout, run the
TP+scatter kernel into ``[T * block_n]`` tile rows, fold the virtual tiles
onto atom rows with ``index_add_`` at ``base + row`` (bases repeat for hub
atoms; padding tiles point at the trash rows ``n_atoms..n_atoms + block_n``,
which are sliced off), divide by ``avg_num_neighbors``.  Backward
(:class:`_InteractionBwd`, the JAX ``_blocked_bwd_op``): the adjoint of the
fold is a gather of cotangent rows into tile layout (trash rows read zeros),
then the gather + TP-transpose kernel, then the adjoints of the host-side
gathers: an un-permuting ``index_add_`` over ``perm`` (masked slots carry
exact zeros, so padding slots only add zeros to edge 0) and a segment-sum of
``dh`` over senders.  The backward's own derivative is the second-order
kernels ``tp_dbl_scatter`` and ``tp_dbl_gather`` (:func:`_blocked_second_order`;
their plain versions on the CPU), which the JAX package leaves to XLA's
autodiff.  A third order raises.

``tp_cuda`` (the registered ``channelwise_tp/cuda`` impl, the JAX
``tp_pallas``) is the blocked op over :func:`identity_blocking` (a tile of
128 slots per 128 edges, each edge its own row) with ``h_node = h_send``,
``senders = arange(E)`` and an average of 1.  Without blocking,
``interaction_cuda_op`` is ``tp_cuda`` followed by
``aggregate_edge_messages``, and autograd composes its derivatives.

``InteractionSpec.bwd_impl`` (the JAX ``"pallas"`` / ``"xla"``) is read in
:func:`interaction_cuda_op` alone: ``"cuda"`` is the route above;
``"fused"`` computes A by the same kernels and takes its backward as the VJP
of ``core.interaction.interaction_fused`` by autograd (:class:`_FusedBwd`),
differentiable to any order.

Precision: ``tp_cuda`` takes ``precision``; the interaction ops read
``InteractionSpec.precision``.  Both route it to the kernels' operand
rounding (``kernels/precision.py``); the second order stays fp32.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.interaction import (
    InteractionSpec,
    aggregate_edge_messages,
    interaction_fused,
)
from repro_torch.kernels import refuse_third_order

from .kernel import tp_dbl_gather, tp_dbl_scatter, tp_gather_bwd, tp_scatter

# edge slots per tile of the identity blocking (the JAX tp_pallas block_e)
IDENTITY_TILE = 128


# ---------------------------------------------------------------------------
# the blocked op
# ---------------------------------------------------------------------------


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


def _blocked_forward(spec, Y, h_node, R, senders, perm, valid, local, base):
    n_atoms = h_node.shape[0]
    _, Y_b, h_b, R_b = _slot_operands(Y, h_node, R, senders, perm)
    A_t = tp_scatter(
        Y_b, h_b, R_b, local, valid, spec.tp,
        n_tiles=base.shape[0], block_n=spec.block_n, precision=spec.precision,
    )                                                        # [T*block_n, d_out, k]
    A = A_t.new_zeros((n_atoms + spec.block_n,) + A_t.shape[1:])
    A.index_add_(0, _tile_rows(base, spec.block_n), A_t)
    return A[:n_atoms].transpose(1, 2) / spec.avg_num_neighbors


def _blocked_backward(spec, g, Y, h_node, R, senders, perm, valid, local, base):
    n_atoms = h_node.shape[0]
    send_b, Y_b, h_b, R_b = _slot_operands(Y, h_node, R, senders, perm)
    # adjoint of (transpose -> /avg -> fold over tile rows): gather the
    # per-atom cotangent into tile layout (trash rows read zeros)
    gt = g.transpose(1, 2) / spec.avg_num_neighbors          # [N, d_out, k]
    gpad = torch.cat([gt, gt.new_zeros((spec.block_n,) + gt.shape[1:])])
    G_t = gpad[_tile_rows(base, spec.block_n)].contiguous()
    dY_b, dh_b, dR_b = tp_gather_bwd(
        G_t, Y_b, h_b, R_b, local, valid, spec.tp,
        n_tiles=base.shape[0], block_n=spec.block_n, precision=spec.precision,
    )
    # un-permute: valid slots are a permutation of the valid edges and
    # masked slots carry exact zeros, so padding slots add zeros to edge 0
    dY = torch.zeros_like(Y).index_add_(0, perm, dY_b)
    dR = torch.zeros_like(R).index_add_(0, perm, dR_b)
    dh = dh_b.new_zeros((n_atoms,) + dh_b.shape[1:]).index_add_(0, send_b, dh_b)
    return dY, dh.transpose(1, 2), dR


def _blocked_second_order(spec, g, Y, h_node, R, senders, perm, valid, local, base,
                          ddY, ddh, ddR):
    """d/d(g, Y, h_node, R) of ``<(ddY, ddh, ddR), _blocked_backward at (g, Y,
    h_node, R)>`` by the second-order kernels, which read every operand row
    through ``perm`` and the slots' senders: the receiver scatter of the
    product rule's messages, folded onto atom rows as the forward folds
    (``dg``), and the per-slot gather of the cotangent rows (``dY`` and
    ``dR`` on the slots' edges, ``dh`` per slot, then summed over senders)."""
    n_atoms, bn, avg = h_node.shape[0], spec.block_n, spec.avg_num_neighbors
    tiles = dict(n_tiles=base.shape[0])
    perm32 = perm.to(torch.int32).contiguous()
    send = senders[perm.long()].to(torch.int32).contiguous()
    h_t, ch_t = (t.transpose(1, 2).contiguous() for t in (h_node, ddh))   # [N, d_h, k]
    Y, ddY, R, ddR = (t.contiguous() for t in (Y, ddY, R, ddR))
    operands = (Y, ddY, h_t, ch_t, R, ddR, perm32, send, local, valid)
    dG_t = tp_dbl_scatter(*operands, spec.tp, **tiles, block_n=bn)
    dg = dG_t.new_zeros((n_atoms + bn,) + dG_t.shape[1:])
    dg.index_add_(0, _tile_rows(base, bn), dG_t)
    G = (g.transpose(1, 2) / avg).contiguous()                # [N, d_out, k]
    dY, dR, dh_b = tp_dbl_gather(G, *operands, base.to(torch.int32).contiguous(),
                                 spec.tp, **tiles)
    dh = dh_b.new_zeros((n_atoms,) + dh_b.shape[1:]).index_add_(0, send.long(), dh_b)
    return dg[:n_atoms].transpose(1, 2) / avg, dY, dh.transpose(1, 2), dR


def _fused_vjp(spec, g, Y, h_node, R, senders, receivers, edge_mask):
    """``bwd_impl="fused"``: the VJP of ``interaction_fused`` by autograd,
    with a graph when the caller builds one, so that a second derivative
    reaches the op's inputs through the formulation's own autodiff.  It is
    taken at aliases of the inputs (``view_as``: new graph nodes over the
    same memory), not at the inputs themselves: one input may depend on
    another (h_node on Y through an earlier layer), and a gradient with
    respect to the inputs would then follow that dependence too.  An input
    that needs no gradient enters as a fresh leaf."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        ins = [t.view_as(t) if t.requires_grad else t.detach().requires_grad_(True)
               for t in (Y, h_node, R)]
        A = interaction_fused(*ins, senders, receivers, edge_mask, spec=spec)
        return torch.autograd.grad(A, ins, g, create_graph=create)


class _InteractionBwd(torch.autograd.Function):
    """``(g [N, k, d_out], Y, h_node, R, senders, perm, valid, local, base)
    -> (dY, dh_node, dR)``: the backward kernel between the adjoints of the
    forward's plain-torch steps, over the edge blocking.  Its own
    derivative is :func:`_blocked_second_order` (the second-order
    kernels)."""

    @staticmethod
    def forward(ctx, g, Y, h_node, R, senders, perm, valid, local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(g, Y, h_node, R, senders, perm, valid, local, base)
        return _blocked_backward(spec, g, Y, h_node, R, senders, perm, valid, local, base)

    @staticmethod
    def backward(ctx, ddY, ddh, ddR):
        refuse_third_order("interaction backward")
        g, Y, h_node, R, senders, perm, valid, local, base = ctx.saved_tensors
        with tracing.span("model.tp_twin", tracing.handed_off()) as sp:
            if sp is not None:
                sp.count("slots", perm.shape[0])
            grads = _blocked_second_order(ctx.spec, g, Y, h_node, R, senders, perm,
                                          valid, local, base, ddY, ddh, ddR)
        return (*grads, None, None, None, None, None, None)


class _Interaction(torch.autograd.Function):
    """``(Y [E, d_sh], h_node [N, k, d_h], R [E, n_paths, k]) -> A [N, k,
    d_out]`` over pre-blocked edges, its backward :class:`_InteractionBwd`."""

    @staticmethod
    def forward(ctx, Y, h_node, R, senders, perm, valid, local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(Y, h_node, R, senders, perm, valid, local, base)
        return _blocked_forward(spec, Y, h_node, R, senders, perm, valid, local, base)

    @staticmethod
    def backward(ctx, g):
        dY, dh, dR = _InteractionBwd.apply(g.contiguous(), *ctx.saved_tensors, ctx.spec)
        return (dY, dh, dR) + (None,) * 6


def _blocked_op(Y, h_node, R, *, senders, blocking, spec):
    perm, base = blocking["perm"], blocking["base"]
    if perm.shape[0] % base.shape[0]:
        raise ValueError("blocking perm length not a multiple of tile count")
    return _Interaction.apply(Y, h_node, R, senders, perm, blocking["valid"],
                              blocking["local"].to(torch.int32).contiguous(), base, spec)


class _FusedBwd(torch.autograd.Function):
    """``bwd_impl="fused"``: A by ``route``'s kernels (its forward runs
    without a graph), its backward :func:`_fused_vjp`."""

    @staticmethod
    def forward(ctx, Y, h_node, R, senders, receivers, edge_mask, spec, route):
        ctx.spec = spec
        ctx.save_for_backward(Y, h_node, R, senders, receivers, edge_mask)
        return route(Y, h_node, R)

    @staticmethod
    def backward(ctx, g):
        return (*_fused_vjp(ctx.spec, g, *ctx.saved_tensors), None, None, None, None, None)


# ---------------------------------------------------------------------------
# the registered impls
# ---------------------------------------------------------------------------


def identity_blocking(n_edges: int, device) -> Dict[str, torch.Tensor]:
    """The blocking under which the blocked op is the TP-only op: tiles of
    ``IDENTITY_TILE`` slots (one at least), slot s reads edge s into its own
    row (``local`` = s mod 128, ``base`` = tile x 128), padding slots read
    edge 0 and are masked; the dtypes of ``data.blocking.blocking_to_batch``."""
    n_tiles = max(1, -(-n_edges // IDENTITY_TILE))
    slots = torch.arange(n_tiles * IDENTITY_TILE, dtype=torch.int32, device=device)
    valid = slots < n_edges
    return {"perm": torch.where(valid, slots, 0), "valid": valid,
            "local": slots % IDENTITY_TILE, "base": slots[::IDENTITY_TILE].contiguous()}


def tp_cuda(
    Y: torch.Tensor,
    h_send: torch.Tensor,
    R: torch.Tensor,
    spec: TPSpec,
    *,
    precision: str = "fp32",
) -> torch.Tensor:
    """Registered ``channelwise_tp/cuda`` impl (``cuda_bf16`` / ``cuda_fp8``
    at a reduced ``precision``): a TP-only drop-in for ``tp_fused``, [E, k,
    d_out], the blocked op over the identity blocking."""
    E = Y.shape[0]
    if E == 0:  # the identity blocking's padding slots read edge 0
        one = [torch.cat([t, t.new_zeros((1,) + t.shape[1:])]) for t in (Y, h_send, R)]
        return tp_cuda(*one, spec, precision=precision)[:0]
    ispec = InteractionSpec(spec, 1.0, block_n=IDENTITY_TILE, precision=precision)
    return _blocked_op(Y, h_send, R, senders=torch.arange(E, device=Y.device),
                       blocking=identity_blocking(E, Y.device), spec=ispec)


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

    With ``blocking`` the kernels read the blocking arrays, which encode
    ``receivers`` and ``edge_mask``; without it the messages come from
    :func:`tp_cuda` and are summed over receivers in plain torch."""
    if blocking is None:
        def route(Y, h_node, R):
            # index_select, whose autodiff is an index_add_ over senders
            msgs = tp_cuda(Y, h_node.index_select(0, senders.long()), R, spec.tp,
                           precision=spec.precision)
            return aggregate_edge_messages(msgs, receivers, edge_mask, h_node.shape[0], spec)
    else:
        route = functools.partial(_blocked_op, senders=senders, blocking=blocking, spec=spec)
    if spec.bwd_impl == "fused":
        return _FusedBwd.apply(Y, h_node, R, senders, receivers, edge_mask, spec, route)
    return route(Y, h_node, R)
