"""Collective traffic, FLOPs and intermediate shapes, counted from the
dispatcher: the counterpart of the JAX package's ``roofline/hlo.py``.

The JAX dry run parses the compiled HLO.  The port compiles no program, so
it counts what a traced step dispatches, under ``TorchDispatchMode``s:

* :func:`count_collectives` sees every collective: the functional ones
  (``_c10d_functional`` / ``c10d_functional``, which DTensor issues when it
  redistributes) and the in-place ``c10d`` ones (``dist.all_reduce`` of the
  DDP step).  Each one's per-device result bytes become transferred bytes
  by ``hlo.py``'s ring factors, with ``g`` the group's size:

      all-reduce          2 (g-1)/g x result
      all-gather            (g-1)/g x result
      reduce-scatter        (g-1)   x result   (operand = g x result)
      all-to-all            (g-1)/g x result
      permute                     1 x result

* :func:`count_flops` applies ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``) op by op: one device's
  FLOPs, the JAX ``cost_analysis`` number of a partitioned program.  An op
  on DTensors is counted at its global shapes and divided by the size of
  the mesh dims its output is split over (``Shard`` or ``Partial``): work
  the mesh replicates (a ``Replicate`` output, as AdamW on replicated
  parameters) counts whole on every device.  An op on plain tensors, as
  in the DDP step where each process holds its own rows, is one device's.

Enter :func:`count_collectives` first and :func:`count_flops` inside it:
the inner mode sees each DTensor op whole (its global shapes); the outer
one defers DTensor ops to DTensor and sees the collectives they become.

* :func:`out_shapes` is the materialization guard (``jaxpr_out_shapes``):
  the set of every tensor shape a call produces.
"""
from __future__ import annotations

import functools
from typing import Dict, Set, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "permute")

_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "permute_tensor": "permute",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}


def _factor(kind: str, g: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    return 1.0


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """The size of the op's group: a functional op's ``group_name``, a
    ``c10d`` op's ``process_group``."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for i, arg in enumerate(func._schema.arguments):
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        if arg.name == "group_name":
            return int(_resolve_process_group(value).size())
        if arg.name == "process_group":
            return int(ProcessGroup.unbox(value).size())
    raise ValueError(f"{func} names no group")


@functools.lru_cache(maxsize=None)
def _kind(func):
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns in ("_c10d_functional", "c10d_functional"):
        return _FUNCTIONAL.get(name)
    if ns == "c10d":
        return _C10D.get(name)
    return None


class count_collectives(TorchDispatchMode):
    """Per-device collective bytes by kind while active: ``bytes`` (each
    kind, and ``"total"``) and ``counts`` (each kind's calls)."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor run it, then see its collectives
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind is not None:
            g = _group_size(func, args, kwargs)
            result = out[0] if func.namespace == "c10d" else out
            self.bytes[kind] = self.bytes.get(kind, 0.0) + _nbytes(result) * _factor(kind, g)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return out

    def result(self) -> Dict[str, float]:
        """``{kind: bytes, ..., "total": bytes}`` (the JAX
        ``collective_bytes_from_hlo``'s keys, without its trip counts)."""
        out = {k: v for k, v in self.bytes.items() if v}
        out["total"] = float(sum(self.bytes.values()))
        return out


def _devices_sharing(out) -> int:
    """How many devices split an op's work: the product of the mesh dims
    its (first) DTensor output is ``Shard`` or ``Partial`` over; 1 for a
    plain tensor."""
    t = next((x for x in tree_leaves(out) if isinstance(x, DTensor)), None)
    if t is None:
        return 1
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if not p.is_replicate():
            n *= size
    return n


class count_flops(TorchDispatchMode):
    """FLOPs per device while active (``flops``), by ``FlopCounterMode``'s
    formulas; see the module docstring for DTensor ops."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out)) / _devices_sharing(out)
        return out


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes: Set[Tuple[int, ...]] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def out_shapes(fn, *args, **kwargs) -> Set[Tuple[int, ...]]:
    """Set of every tensor shape ``fn(*args, **kwargs)`` produces, op by op
    (outputs of every dispatched op, the backward's included if ``fn``
    runs one).  Used as a materialization guard: e.g. the fused
    interaction op must never produce an ``[E, k, d_out]`` per-edge message
    tensor (paper §4)."""
    with _Shapes() as mode:
        fn(*args, **kwargs)
    return mode.shapes
