"""Public wrappers for the interaction kernels: the port of the JAX package's
``kernels/channelwise_tp/ops.py``.

Batch contract: edge blocking is a data-pipeline product
(``data.blocking.block_edges``); its arrays ride inside the batch under the
``blk_*`` keys and reach :func:`interaction_cuda_op` as ``blocking``.

``interaction_cuda_op``
    The registered ``interaction/cuda`` impl (and ``cuda_bf16`` /
    ``cuda_fp8``).  With blocking it runs the fused TP+scatter kernel over
    the pre-blocked edges.  Forward (plain torch around the kernel, as it is
    XLA around the kernel in JAX): gather ``Y[perm]``, ``h[senders[perm]]``
    and ``R[perm]`` into slot layout, run the TP+scatter kernel into
    ``[T * block_n]`` tile rows, fold the virtual tiles onto atom rows with
    ``index_add_`` at ``base + row`` (bases repeat for hub atoms; padding
    tiles point at the trash rows ``n_atoms..n_atoms + block_n``, which are
    sliced off), divide by ``avg_num_neighbors``.  Backward: the adjoint of
    the fold is a gather of cotangent rows into tile layout (trash rows read
    zeros), then the gather + TP-transpose kernel, then the adjoints of the
    host-side gathers: an un-permuting ``index_add_`` over ``perm`` (masked
    slots carry exact zeros, so padding slots only add zeros to edge 0) and
    a segment-sum of ``dh`` over senders.
    Without blocking (the JAX ``_unblocked_forward`` / ``_unblocked_bwd_op``)
    it runs the same two kernels on the identity blocking of :func:`tp_cuda`
    (one tile per 128 edges, each edge its own row) and sums over receivers
    in plain torch: forward ``tp_cuda`` + ``aggregate_edge_messages``;
    backward a receiver gather of the cotangent (masked, divided by the
    average), the identity-blocked backward kernel, and an ``index_add_`` of
    ``dh`` over senders.

``tp_cuda``
    The registered ``channelwise_tp/cuda`` impl (the JAX ``tp_pallas``): a
    TP-only drop-in for ``tp_fused``, both kernels under the identity
    blocking.

The backward (``InteractionSpec.bwd_impl``, the JAX ``"pallas"`` /
``"xla"``): ``"cuda"`` runs the backward kernel above; ``"fused"`` is the
VJP of ``core.interaction.interaction_fused`` taken by autograd at
aliases of the op's saved inputs (:func:`_fused_vjp`), so its graph reaches
them and it differentiates to any order.

Every op is a ``torch.autograd.Function`` that saves only its own inputs
(with ``receivers`` and ``edge_mask``, which the blocking arrays encode but
the unblocked second-order rule reads).  Each backward kernel is itself an
``autograd.Function`` (:class:`_InteractionBwd`, the JAX package's
``_blocked_bwd_op`` / ``_unblocked_bwd_op``; :class:`_TPBwd`, its
``_tp_bwd_op``).  Over the blocking, the derivative of the backward is the
second-order kernels ``tp_dbl_scatter`` and ``tp_dbl_gather``
(:func:`_blocked_second_order`; their plain versions on the CPU), which the
JAX package leaves to XLA's autodiff.  Without the blocking, and for the
TP-only op, it is the double VJP of the plain twin (``interaction_fused``
over the unblocked arrays, ``tp_fused``), taken in chunks of edges (exact:
both are sums over edges) so that their ``[E, k, nnz]`` intermediates stay
a fixed size.  A third order raises.

Precision: ``tp_cuda`` takes ``precision``; the interaction ops read
``InteractionSpec.precision``.  Both route it to the kernels' operand
rounding (``kernels/precision.py``); the second order stays fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.channelwise_tp import TPSpec, tp_fused
from repro_torch.core.interaction import (
    InteractionSpec,
    aggregate_edge_messages,
    interaction_fused,
)
from repro_torch.kernels import refuse_third_order
from repro_torch.kernels.precision import check_precision

from .kernel import tp_dbl_gather, tp_dbl_scatter, tp_gather_bwd, tp_scatter

# edges per chunk of the autograd twins (the unblocked and TP-only second
# orders): their autodiff keeps about a dozen [chunk, k, nnz] fp32 tensors
# live, 4.3 GB at k = 128 and nnz = 86 (the paper's layer 1), where the
# 147,456 edges of a 3,072-atom bin at once would need 78 GB
TWIN_CHUNK_EDGES = 8192
# edge slots per tile of the identity blocking (the JAX tp_pallas block_e)
IDENTITY_TILE = 128


# ---------------------------------------------------------------------------
# the TP-only op: both kernels under the identity blocking
# ---------------------------------------------------------------------------


def _identity_operands(Y, h_send, R):
    """Y, h and R padded to whole tiles of ``IDENTITY_TILE`` edges (one at
    least) in kernel layout, and the identity blocking: slot s of a tile is
    row s of that tile, every slot valid (padding slots hold zeros and land
    in rows that are sliced off)."""
    E = Y.shape[0]
    E_p = max(1, -(-E // IDENTITY_TILE)) * IDENTITY_TILE
    pad = (0, 0, 0, 0, 0, E_p - E)
    Y_b = F.pad(Y, (0, 0, 0, E_p - E)).contiguous()              # [E_p, d_sh]
    h_b = F.pad(h_send.transpose(1, 2), pad).contiguous()       # [E_p, d_h, k]
    R_b = F.pad(R, pad).contiguous()                            # [E_p, n_paths, k]
    n_tiles = E_p // IDENTITY_TILE
    local = torch.arange(IDENTITY_TILE, dtype=torch.int32, device=Y.device).repeat(n_tiles)
    valid = torch.ones(E_p, dtype=torch.bool, device=Y.device)
    return (Y_b, h_b, R_b, local, valid), dict(n_tiles=n_tiles, block_n=IDENTITY_TILE)


def _tp_forward(Y, h_send, R, spec: TPSpec, precision: str):
    """Messages [E, k, d_out] by the TP+scatter kernel, identity-blocked."""
    operands, tiles = _identity_operands(Y, h_send, R)
    A_t = tp_scatter(*operands, spec, **tiles, precision=precision)  # [E_p, d_out, k]
    return A_t[: Y.shape[0]].transpose(1, 2)


def _tp_backward(g, Y, h_send, R, spec: TPSpec, precision: str):
    """(dY, dh_send, dR) from the message cotangent g [E, k, d_out] by the
    gather + TP-transpose kernel, identity-blocked."""
    operands, tiles = _identity_operands(Y, h_send, R)
    E, E_p = Y.shape[0], operands[0].shape[0]
    G_t = F.pad(g.transpose(1, 2), (0, 0, 0, 0, 0, E_p - E)).contiguous()
    dY_b, dh_b, dR_b = tp_gather_bwd(G_t, *operands, spec, **tiles, precision=precision)
    return dY_b[:E], dh_b[:E].transpose(1, 2), dR_b[:E]


def _tp_twin_second_order(spec, g, Y, h_send, R, ddY, ddh, ddR):
    """d/d(g, Y, h_send, R) of ``<(ddY, ddh, ddR), VJP of tp_fused at (Y,
    h_send, R) with g>``, one chunk of edges at a time (every edge is its
    own term)."""
    outs = [torch.empty_like(t) for t in (g, Y, h_send, R)]
    for lo in range(0, Y.shape[0], TWIN_CHUNK_EDGES):
        sl = slice(lo, lo + TWIN_CHUNK_EDGES)
        with torch.enable_grad():
            ins = [t[sl].detach().requires_grad_(True) for t in (g, Y, h_send, R)]
            first = torch.autograd.grad(tp_fused(*ins[1:], spec), ins[1:], ins[0],
                                        create_graph=True)
            parts = torch.autograd.grad(first, ins, (ddY[sl], ddh[sl], ddR[sl]),
                                        allow_unused=True)
        for out, part in zip(outs, parts):
            out[sl] = 0.0 if part is None else part
    return outs


class _TPBwd(torch.autograd.Function):
    """``(g [E, k, d_out], Y, h_send, R) -> (dY, dh_send, dR)``: the
    identity-blocked backward kernel, whose own derivative is
    :func:`_tp_twin_second_order`."""

    @staticmethod
    def forward(ctx, g, Y, h_send, R, spec, precision):
        ctx.spec = spec
        ctx.save_for_backward(g, Y, h_send, R)
        return _tp_backward(g, Y, h_send, R, spec, precision)

    @staticmethod
    def backward(ctx, ddY, ddh, ddR):
        refuse_third_order("tp backward")
        with tracing.span("model.tp_twin", tracing.handed_off()):
            grads = _tp_twin_second_order(ctx.spec, *ctx.saved_tensors, ddY, ddh, ddR)
        return (*grads, None, None)


class _TPOp(torch.autograd.Function):
    """``(Y [E, d_sh], h_send [E, k, d_h], R [E, n_paths, k]) -> [E, k,
    d_out]``."""

    @staticmethod
    def forward(ctx, Y, h_send, R, spec, precision):
        ctx.spec, ctx.precision = spec, precision
        ctx.save_for_backward(Y, h_send, R)
        return _tp_forward(Y, h_send, R, spec, precision)

    @staticmethod
    def backward(ctx, g):
        grads = _TPBwd.apply(g, *ctx.saved_tensors, ctx.spec, ctx.precision)
        return (*grads, None, None)


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
    d_out], forward and backward by the interaction kernels under the
    identity blocking."""
    return _TPOp.apply(Y, h_send, R, spec, check_precision(precision))


# ---------------------------------------------------------------------------
# the interaction op, blocked and unblocked
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


def _unblocked_forward(spec, Y, h_node, R, senders, receivers, edge_mask):
    msgs = _tp_forward(Y, h_node[senders.long()], R, spec.tp, spec.precision)
    return aggregate_edge_messages(msgs, receivers, edge_mask, h_node.shape[0], spec)


def _unblocked_backward(spec, g, Y, h_node, R, senders, receivers, edge_mask):
    gmsg = (g[receivers.long()] * edge_mask.to(g.dtype)[:, None, None]
            / spec.avg_num_neighbors)                        # [E, k, d_out]
    dY, dh_e, dR = _tp_backward(gmsg, Y, h_node[senders.long()], R, spec.tp,
                                spec.precision)
    dh = torch.zeros_like(h_node).index_add_(0, senders.long(), dh_e)
    return dY, dh, dR


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
    """``(g [N, k, d_out], Y, h_node, R, senders, receivers, edge_mask,
    perm, valid, local, base) -> (dY, dh_node, dR)``: the backward kernel
    between the adjoints of the forward's plain-torch steps, over the edge
    blocking when ``perm`` is given, else unblocked.  Its own derivative is
    :func:`_blocked_second_order` (the second-order kernels) over the
    blocking, :func:`_twin_second_order` without it."""

    @staticmethod
    def forward(ctx, g, Y, h_node, R, senders, receivers, edge_mask, perm, valid,
                local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(g, Y, h_node, R, senders, receivers, edge_mask, perm,
                              valid, local, base)
        if perm is None:
            return _unblocked_backward(spec, g, Y, h_node, R, senders, receivers,
                                       edge_mask)
        return _blocked_backward(spec, g, Y, h_node, R, senders, perm, valid, local, base)

    @staticmethod
    def backward(ctx, ddY, ddh, ddR):
        refuse_third_order("interaction backward")
        g, Y, h_node, R, senders, receivers, edge_mask, perm, valid, local, base = (
            ctx.saved_tensors)
        with tracing.span("model.tp_twin", tracing.handed_off()) as sp:
            if perm is None:
                grads = _twin_second_order(ctx.spec, g, Y, h_node, R, senders, receivers,
                                           edge_mask, ddY, ddh, ddR)
            else:
                if sp is not None:
                    sp.count("slots", perm.shape[0])
                grads = _blocked_second_order(ctx.spec, g, Y, h_node, R, senders, perm,
                                              valid, local, base, ddY, ddh, ddR)
        return (*grads, None, None, None, None, None, None, None, None)


class _Interaction(torch.autograd.Function):
    """``(Y [E, d_sh], h_node [N, k, d_h], R [E, n_paths, k]) -> A [N, k,
    d_out]``, over pre-blocked edges when ``perm`` is given; the backward
    as ``spec.bwd_impl`` says."""

    @staticmethod
    def forward(ctx, Y, h_node, R, senders, receivers, edge_mask, perm, valid,
                local, base, spec):
        ctx.spec = spec
        ctx.save_for_backward(Y, h_node, R, senders, receivers, edge_mask,
                              perm, valid, local, base)
        if perm is None:
            return _unblocked_forward(spec, Y, h_node, R, senders, receivers, edge_mask)
        return _blocked_forward(spec, Y, h_node, R, senders, perm, valid, local, base)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.spec.bwd_impl == "fused":
            dY, dh, dR = _fused_vjp(ctx.spec, g, *saved[:6])
        else:
            dY, dh, dR = _InteractionBwd.apply(g.contiguous(), *saved, ctx.spec)
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

    With ``blocking`` the kernels read the blocking arrays, which encode
    ``receivers`` and ``edge_mask``; the op keeps both for its second-order
    rule.  Without it the op takes the unblocked path."""
    if blocking is None:
        return _Interaction.apply(Y, h_node, R, senders, receivers, edge_mask,
                                  None, None, None, None, spec)
    perm, base = blocking["perm"], blocking["base"]
    if perm.shape[0] % base.shape[0]:
        raise ValueError("blocking perm length not a multiple of tile count")
    return _Interaction.apply(
        Y, h_node, R, senders, receivers, edge_mask, perm, blocking["valid"],
        blocking["local"].to(torch.int32).contiguous(), base, spec,
    )
