"""Process-group topology of the port's data-parallel engines.

The ``torch.distributed`` counterpart of the JAX package's
``launch/mesh.py`` ``make_dp_mesh`` and ``make_node_device_mesh``.  The
port runs one process per rank, so where the JAX engines shard one program
over a device mesh, the port's engines reduce over process groups:

* :func:`make_dp_group` — the flat data group (the whole world) of
  ``DataParallelEngine``;
* :func:`make_node_device_groups` — the two levels of ``MultiHostEngine``:
  rank ``r`` is node ``r // devices_per_node``, local device ``r %
  devices_per_node`` (node-major, the order of the JAX ``("node",
  "device")`` mesh's flattened data axis and of
  ``HierarchicalBalancedSampler``); a ``device`` group per node holds its
  ranks, a ``node`` group per local device index holds that device of every
  node.

``dist.new_group`` must be called by every rank, in one order, for every
group, including the groups a rank is not in: both functions loop over all
groups on every rank.  A level of size 1 gets no group (``None``): its mean
is the identity, not a collective over one rank.
"""
from __future__ import annotations

import torch.distributed as dist


def _require_world(n_ranks: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "repro_torch.launch.multihost.initialize_distributed first"
        )
    world = dist.get_world_size()
    if world != n_ranks:
        raise ValueError(
            f"need {n_ranks} processes (one per rank), the process group has {world}"
        )


def make_dp_group(n_ranks: int):
    """The flat data group of ``n_ranks`` processes: the default group,
    after checking that it holds exactly one process per rank."""
    _require_world(n_ranks)
    return dist.group.WORLD


def make_node_device_groups(n_nodes: int, devices_per_node: int):
    """``(device_group, node_group)`` of this rank in ``n_nodes *
    devices_per_node`` processes, rank ``r`` at node ``r //
    devices_per_node``, device ``r % devices_per_node``: its node's ranks
    (the intra-node hop) and this device index on every node (the
    inter-node hop), each ``None`` where that level has one rank."""
    if n_nodes < 1 or devices_per_node < 1:
        raise ValueError("n_nodes and devices_per_node must be >= 1")
    _require_world(n_nodes * devices_per_node)
    node, device = divmod(dist.get_rank(), devices_per_node)
    device_group = node_group = None
    if devices_per_node > 1:
        for n in range(n_nodes):
            g = dist.new_group([n * devices_per_node + d for d in range(devices_per_node)])
            if n == node:
                device_group = g
    if n_nodes > 1:
        for d in range(devices_per_node):
            g = dist.new_group([n * devices_per_node + d for n in range(n_nodes)])
            if d == device:
                node_group = g
    return device_group, node_group
