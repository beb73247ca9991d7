"""The interaction op: channelwise TP + receiver scatter + neighbor norm,

    A_i = (1 / avg_num_neighbors) * sum_{j in N(i)} TP(Y_ji, h_j, R_ji)

Port of the spec half of the JAX package's ``core/interaction.py``.  Every
impl shares one signature, bound to an :class:`InteractionSpec` by the
registry:

    fn(Y, h_node, R, senders, receivers, edge_mask, *, blocking=None) -> A

with ``Y [E, dim_sh]``, ``h_node [N, k, dim_h]``, ``R [E, n_paths, k]`` and
``A [N, k, dim_out]``.  ``blocking`` is the array half of the data-pipeline
blocking contract (``data.blocking.blocking_from_batch``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import registry

from .channelwise_tp import TPSpec


@dataclasses.dataclass(frozen=True)
class InteractionSpec:
    """Static description of one interaction op (hashable: registry key)."""

    tp: TPSpec
    avg_num_neighbors: float
    # atom rows per kernel tile; must equal the data pipeline's
    # BinShape.block_n (the serving engine validates this)
    block_n: int = 32


def resolve_interaction(name: str, spec: InteractionSpec):
    """Resolve an interaction impl by name through ``kernels.registry``."""
    return registry.resolve("interaction", name, spec)
