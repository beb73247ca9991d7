"""Process-group topology of the port's data-parallel engines, and the LM
scaffold's device meshes.

The ``torch.distributed`` counterpart of the JAX package's
``launch/mesh.py``: ``make_production_mesh``, ``dp_axes`` and
``make_test_mesh`` as ``DeviceMesh``es (at the end of this module), and
``make_dp_mesh`` and ``make_node_device_mesh`` as process groups.  The
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


# --------------------------- device meshes ----------------------------------
#
# The LM scaffold's meshes, the counterpart of the JAX ``make_production_mesh``
# / ``dp_axes`` / ``make_test_mesh``: a ``DeviceMesh`` over the current
# process group (one process per device), with the JAX axis names.  The
# sharding rules (``launch/sharding.py``) read the names and the sizes.

PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 256-device ``(16, 16)`` ``("data", "model")`` mesh, or with
    ``multi_pod`` the 512-device ``(2, 16, 16)`` ``("pod", "data",
    "model")`` one, over the current world, which must hold exactly that
    many processes.  The dry run builds it with ``device_type="cpu"`` over a
    fake process group and places meta tensors on it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    _require_world(n)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (pod folds into DP)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda"):
    """A small mesh over the current world (which must hold
    ``prod(shape)`` processes): the CPU tests' ``(2, 2)`` over gloo
    processes with ``device_type="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    _require_world(n)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
