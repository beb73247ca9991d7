"""Plain oracles for the channelwise-TP(+scatter) kernels (port of the JAX
package's ``kernels/channelwise_tp/ref.py``): the e3nn-style per-path
dense-CG einsum chain, and the whole interaction op (TP -> masked receiver
sum -> / avg_num_neighbors) the fused kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.core.channelwise_tp import TPSpec, tp_ref
from repro_torch.core.interaction import InteractionSpec, interaction_ref


def tp_reference(Y, h_send, R, spec: TPSpec) -> torch.Tensor:
    return tp_ref(Y, h_send, R, spec)


def interaction_reference(
    Y, h_node, R, senders, receivers, edge_mask, spec: InteractionSpec
) -> torch.Tensor:
    """Oracle for the fused TP+scatter kernel: A [N, k, d_out]."""
    return interaction_ref(Y, h_node, R, senders, receivers, edge_mask, spec=spec)
