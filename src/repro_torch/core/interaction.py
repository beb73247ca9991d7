"""The interaction op: channelwise TP + receiver scatter + neighbor norm,

    A_i = (1 / avg_num_neighbors) * sum_{j in N(i)} TP(Y_ji, h_j, R_ji)

Port of the JAX package's ``core/interaction.py``: the spec, and the two
plain-torch formulations, registered as the ``ref`` and ``fused`` impls of
the ``interaction`` kind: :func:`interaction_ref` (dense TP messages, then
the receiver sum) and :func:`interaction_fused` (the sum taken in the nnz
basis; its double VJP is what the tests hold the interaction's second-order
kernels to, and its VJP the ``bwd_impl="fused"`` backward).  The ``cuda``
impls live in ``kernels/channelwise_tp/ops.py``.  Every registered impl shares
one signature, bound to an :class:`InteractionSpec` by the registry:

    fn(Y, h_node, R, senders, receivers, edge_mask, *, blocking=None) -> A

with ``Y [E, dim_sh]``, ``h_node [N, k, dim_h]``, ``R [E, n_paths, k]`` and
``A [N, k, dim_out]``.  ``blocking`` is the array half of the data-pipeline
blocking contract (``data.blocking.blocking_from_batch``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.precision import check_precision

from .channelwise_tp import (
    TPSpec,
    TPTables,
    build_tp_tables,
    cg_scatter_matrix,
    tp_contrib,
    tp_ref,
)


@dataclasses.dataclass(frozen=True)
class InteractionSpec:
    """Static description of one interaction op (hashable: registry key)."""

    tp: TPSpec
    avg_num_neighbors: float
    # atom rows per kernel tile; must equal the data pipeline's
    # BinShape.block_n (the serving and training engines validate this)
    block_n: int = 32
    # backward of the cuda impls (the JAX package's "pallas" / "xla"):
    # "cuda" runs the gather + TP-transpose backward kernel; "fused" is the
    # VJP of interaction_fused by autograd, differentiable to any order.
    # ref and fused impls ignore it.
    bwd_impl: str = "cuda"
    # operand precision of the cuda kernels (forward and backward): reduced
    # precisions round the loaded operands, every sum stays fp32
    # (kernels/precision.py).  ref and fused impls ignore it (always fp32);
    # the second order stays fp32 at every setting.
    precision: str = "fp32"

    def __post_init__(self):
        if self.bwd_impl not in ("cuda", "fused"):
            raise ValueError(
                f"bwd_impl must be 'cuda' or 'fused', got {self.bwd_impl!r}"
            )
        check_precision(self.precision)


def resolve_interaction(name: str, spec: InteractionSpec):
    """Resolve an interaction impl by name through ``kernels.registry``.

    A name registered only under the ``channelwise_tp`` kind (a TP-only
    kernel, the registry's extension point) falls back to that impl wrapped
    in the oracle aggregation (gather -> mask -> receiver sum -> /avg), so
    ``MaceConfig(interaction_impl="<registered>")`` keeps working."""
    # check registration first, so that a KeyError raised inside a
    # registered builder propagates instead of selecting the fallback
    if name in registry.available("interaction"):
        return registry.resolve("interaction", name, spec)
    if name not in registry.available("channelwise_tp"):
        raise KeyError(
            f"no interaction or channelwise_tp impl {name!r}; "
            f"interaction: {registry.available('interaction')}, "
            f"channelwise_tp: {registry.available('channelwise_tp')}"
        )
    tp_fn = registry.resolve("channelwise_tp", name, spec.tp)

    def tp_wrapped(Y, h_node, R, senders, receivers, edge_mask, *, blocking=None):
        del blocking
        msgs = tp_fn(Y, h_node[senders.long()], R)
        return aggregate_edge_messages(msgs, receivers, edge_mask, h_node.shape[0], spec)

    return tp_wrapped


def aggregate_edge_messages(
    msgs: torch.Tensor,       # [E, k, d] per-edge messages (any basis)
    receivers: torch.Tensor,  # [E] int
    edge_mask: torch.Tensor,  # [E] bool
    n_atoms: int,
    spec: InteractionSpec,
) -> torch.Tensor:
    """The aggregation tail every decomposed interaction path shares: mask
    -> sum over receivers -> /avg_num_neighbors."""
    msgs = msgs * edge_mask.to(msgs.dtype)[:, None, None]
    out = msgs.new_zeros((n_atoms,) + msgs.shape[1:])
    return out.index_add(0, receivers.long(), msgs) / spec.avg_num_neighbors


def interaction_ref(
    Y: torch.Tensor,          # [E, dim_sh]
    h_node: torch.Tensor,     # [N, k, dim_h]
    R: torch.Tensor,          # [E, n_paths, k]
    senders: torch.Tensor,    # [E] int
    receivers: torch.Tensor,  # [E] int
    edge_mask: torch.Tensor,  # [E] bool
    *,
    spec: InteractionSpec,
    blocking=None,
) -> torch.Tensor:
    """Oracle: e3nn-style TP -> [E, k, d_out] messages -> receiver sum."""
    del blocking
    msgs = tp_ref(Y, h_node[senders.long()], R, spec.tp)
    return aggregate_edge_messages(msgs, receivers, edge_mask, h_node.shape[0], spec)


def interaction_fused(
    Y: torch.Tensor,
    h_node: torch.Tensor,
    R: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    spec: InteractionSpec,
    tables: TPTables | None = None,
    blocking=None,
) -> torch.Tensor:
    """nnz-basis aggregation: the [E, k, nnz] contributions are summed over
    receivers and projected to dim_out per atom, never per edge."""
    del blocking
    t = tables if tables is not None else build_tp_tables(spec.tp)
    # index_select, whose autodiff is an index_add_ (not PyTorch's sort-based
    # indexing backward): this twin is differentiated twice in training
    h_send = h_node.index_select(0, senders.long())
    contrib = tp_contrib(Y, h_send, R, t)                     # [E, k, nnz]
    contrib = contrib * edge_mask.to(contrib.dtype)[:, None, None]
    pre = contrib.new_zeros((h_node.shape[0],) + contrib.shape[1:])
    pre = pre.index_add(0, receivers.long(), contrib)         # [N, k, nnz]
    A = pre @ cg_scatter_matrix(t, pre.dtype, pre.device)     # [N, k, d_out]
    return A / spec.avg_num_neighbors
