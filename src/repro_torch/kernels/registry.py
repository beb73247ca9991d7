"""Kernel dispatch registry: one name -> implementation table per hot spot.

Port of the JAX package's ``kernels/registry.py``, cut to what the serving
slice reads.  One impl is registered for each kind:

  ``cuda``  hand-written CUDA kernels for Hopper (``csrc/``), forward and
            backward, behind ``torch.autograd.Function``s.  On a CPU tensor
            each kernel wrapper runs its plain PyTorch version instead.

    from repro_torch.kernels.registry import resolve
    sc_fn = resolve("symcon", "cuda", spec)        # (A, species, W) -> B
    int_fn = resolve("interaction", "cuda", spec)  # (Y, h, R, ..., blocking=)

``resolve`` binds the implementation to a spec and memoises the binding per
``(kind, name, spec)``.  Capability metadata: ``consumes_blocking`` marks an
impl that reads the data pipeline's pre-blocked edges (the serving engine
then collates the ``blk_*`` arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

KIND_SYMCON = "symcon"
KIND_INTERACTION = "interaction"
KINDS = (KIND_SYMCON, KIND_INTERACTION)

Builder = Callable[[Any], Callable]  # spec -> bound kernel callable


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a kernel kind."""

    kind: str
    name: str
    builder: Builder
    # impl reads the data pipeline's pre-blocked edges (``data.blocking``)
    consumes_blocking: bool = False
    description: str = ""


_REGISTRY: Dict[Tuple[str, str], KernelImpl] = {}
_BIND_CACHE: Dict[Tuple[str, str, Any], Callable] = {}


def _check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise KeyError(f"unknown kernel kind {kind!r}; known: {KINDS}")
    return kind


def register(
    kind: str,
    name: str,
    *,
    consumes_blocking: bool = False,
    description: str = "",
) -> Callable[[Builder], Builder]:
    """Decorator registering ``builder(spec) -> callable`` under a name."""
    kind = _check_kind(kind)

    def deco(builder: Builder) -> Builder:
        if (kind, name) in _REGISTRY:
            raise ValueError(f"kernel {kind}/{name} already registered")
        _REGISTRY[(kind, name)] = KernelImpl(
            kind=kind, name=name, builder=builder,
            consumes_blocking=consumes_blocking, description=description,
        )
        return builder

    return deco


def get_impl(kind: str, name: str) -> KernelImpl:
    kind = _check_kind(kind)
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        raise KeyError(
            f"no kernel impl {name!r} for kind {kind!r}; "
            f"available: {available(kind)}"
        ) from None


def available(kind: str) -> List[str]:
    """Registered impl names for ``kind``."""
    kind = _check_kind(kind)
    return sorted(n for (k, n) in _REGISTRY if k == kind)


def resolve(kind: str, name: str, spec: Any) -> Callable:
    """Bind impl ``name`` to ``spec``; memoised per (kind, name, spec)."""
    key = (_check_kind(kind), name, spec)
    fn = _BIND_CACHE.get(key)
    if fn is None:
        fn = get_impl(kind, name).builder(spec)
        _BIND_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# built-in implementations
# ---------------------------------------------------------------------------


@register(KIND_SYMCON, "cuda",
          description="CUDA symmetric-contraction kernels, fwd + bwd")
def _symcon_cuda_builder(spec):
    from functools import partial

    from repro_torch.kernels.symmetric_contraction.ops import symcon_cuda

    return partial(symcon_cuda, spec=spec)


@register(KIND_INTERACTION, "cuda", consumes_blocking=True,
          description="fused TP+scatter CUDA kernel over pre-blocked edges; "
                      "backward = blocked gather + TP-transpose kernel")
def _interaction_cuda_builder(spec):
    from functools import partial

    from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op

    return partial(interaction_cuda_op, spec=spec)
