"""Kernel dispatch registry: one name -> implementation table per hot spot.

Port of the JAX package's ``kernels/registry.py``.  Three kinds, the
channelwise tensor product (``channelwise_tp``, Algorithm 2), the symmetric
contraction (``symcon``, Algorithm 3) and the interaction op
(``interaction``: TP + receiver scatter + neighbour norm as one op), each
in five implementations:

  ``ref``       per-path dense-CG einsums (the oracle)
  ``fused``     the sparse-table formulation in plain PyTorch
  ``cuda``      hand-written CUDA kernels for Hopper (``csrc/``), forward
                and backward, behind ``torch.autograd.Function``s; on a CPU
                tensor each kernel wrapper runs its plain PyTorch version
  ``cuda_bf16`` / ``cuda_fp8``
                the same kernels with their operands rounded to bf16 / e4m3
                fp8 as they are loaded, fp32 accumulation
                (``kernels/precision.py``)

The JAX package's names map onto these (``bridge.JAX_IMPL_NAMES``):
``pallas`` -> ``cuda``, ``pallas_<p>`` -> ``cuda_<p>``.

    from repro_torch.kernels.registry import resolve
    tp_fn = resolve("channelwise_tp", "cuda", spec)  # (Y, h_send, R) -> msgs
    sc_fn = resolve("symcon", "cuda", spec)          # (A, species, W) -> B
    int_fn = resolve("interaction", "cuda", spec)    # (Y, h, R, ..., blocking=)

``resolve`` binds the implementation to a spec and memoises the binding per
``(kind, name, spec)``.  Capability metadata lets callers filter:
``platforms`` (where an impl runs compiled), ``interpret_only_on`` (where it
runs its plain versions instead: the ``cuda`` impls on the CPU),
``needs_tables``, ``consumes_blocking`` (the impl reads the data pipeline's
pre-blocked edges, so the engines collate the ``blk_*`` arrays),
``uses_kernel`` (it runs hand-written kernels: the JAX ``uses_pallas``),
``has_custom_bwd`` (its backward is a hand-written kernel) and
``precision``.  Every ``cuda`` impl carries its own backward, so the JAX
package's guard for a compiled forward without one has no counterpart.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

# Kernel kinds understood by the registry.  ``KIND_ALIASES`` maps shorthand
# used by configs to the canonical kind name.
KIND_TP = "channelwise_tp"
KIND_SYMCON = "symcon"
KIND_INTERACTION = "interaction"
KINDS = (KIND_TP, KIND_SYMCON, KIND_INTERACTION)
KIND_ALIASES = {
    "tp": KIND_TP,
    "symmetric_contraction": KIND_SYMCON,
    "tp_scatter": KIND_INTERACTION,
}
PLATFORMS = ("cpu", "gpu")

Builder = Callable[[Any], Callable]  # spec -> bound kernel callable


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a kernel kind."""

    kind: str
    name: str
    builder: Builder
    needs_tables: bool = False          # builds sparse lookup tables at bind time
    platforms: Tuple[str, ...] = PLATFORMS
    interpret_only_on: Tuple[str, ...] = ()   # platforms where it runs plain versions
    # impl reads the data pipeline's pre-blocked edges (``data.blocking``)
    consumes_blocking: bool = False
    # impl launches hand-written kernels (the JAX package's ``uses_pallas``)
    uses_kernel: bool = False
    # impl's backward is a hand-written kernel behind an autograd.Function
    has_custom_bwd: bool = False
    # compute precision ("fp32" | "bf16" | "fp8"): reduced-precision impls
    # round loaded operands and keep fp32 accumulation
    precision: str = "fp32"
    description: str = ""

    def supports(self, platform: str) -> bool:
        return platform in self.platforms or platform in self.interpret_only_on

    def compiled_on(self, platform: str) -> bool:
        """True when the impl runs its own code on ``platform`` (for a cuda
        impl: its kernels), the only mode whose speed means anything."""
        return platform in self.platforms

    def interpret_on(self, platform: str) -> bool:
        return platform in self.interpret_only_on

    def platform_mode(self, platform: str) -> Optional[str]:
        """``"compiled"``, ``"interpret"`` (runs, through plain versions) or
        ``None`` (unsupported) on ``platform``."""
        if self.compiled_on(platform):
            return "compiled"
        if self.interpret_on(platform):
            return "interpret"
        return None


_REGISTRY: Dict[Tuple[str, str], KernelImpl] = {}
# (kind, name, spec) -> bound callable; specs are frozen dataclasses
_BIND_CACHE: Dict[Tuple[str, str, Any], Callable] = {}


def canonical_kind(kind: str) -> str:
    kind = KIND_ALIASES.get(kind, kind)
    if kind not in KINDS:
        raise KeyError(f"unknown kernel kind {kind!r}; known: {KINDS}")
    return kind


def _drop_bindings(kind: str, name: str) -> None:
    for key in [k for k in _BIND_CACHE if k[:2] == (kind, name)]:
        del _BIND_CACHE[key]


def register(
    kind: str,
    name: str,
    *,
    needs_tables: bool = False,
    platforms: Tuple[str, ...] = PLATFORMS,
    interpret_only_on: Tuple[str, ...] = (),
    consumes_blocking: bool = False,
    uses_kernel: bool = False,
    has_custom_bwd: bool = False,
    precision: str = "fp32",
    description: str = "",
    overwrite: bool = False,
) -> Callable[[Builder], Builder]:
    """Decorator registering ``builder(spec) -> callable`` under a name."""
    kind = canonical_kind(kind)

    def deco(builder: Builder) -> Builder:
        if (kind, name) in _REGISTRY and not overwrite:
            raise ValueError(f"kernel {kind}/{name} already registered")
        _REGISTRY[(kind, name)] = KernelImpl(
            kind=kind, name=name, builder=builder, needs_tables=needs_tables,
            platforms=platforms, interpret_only_on=interpret_only_on,
            consumes_blocking=consumes_blocking, uses_kernel=uses_kernel,
            has_custom_bwd=has_custom_bwd, precision=precision,
            description=description,
        )
        _drop_bindings(kind, name)  # a re-registration invalidates bindings
        return builder

    return deco


def unregister(kind: str, name: str) -> None:
    kind = canonical_kind(kind)
    _REGISTRY.pop((kind, name), None)
    _drop_bindings(kind, name)


def get_impl(kind: str, name: str) -> KernelImpl:
    kind = canonical_kind(kind)
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        raise KeyError(
            f"no kernel impl {name!r} for kind {kind!r}; "
            f"available: {available(kind)}"
        ) from None


def available(
    kind: str,
    platform: Optional[str] = None,
    *,
    with_custom_bwd: Optional[bool] = None,
    compiled_only: bool = False,
    precision: Optional[str] = None,
) -> List[str]:
    """Impl names for ``kind``, optionally filtered: by support on
    ``platform``, by whether the backward is a hand-written kernel
    (``with_custom_bwd``), to the impls that run their own code on
    ``platform`` (``compiled_only``, which needs ``platform``: the cuda
    impls are not candidates on the CPU), and by ``precision``."""
    kind = canonical_kind(kind)
    if compiled_only and platform is None:
        raise ValueError("compiled_only=True needs an explicit platform")
    out = []
    for (k, n), impl in sorted(_REGISTRY.items()):
        if k != kind:
            continue
        if platform is not None and not impl.supports(platform):
            continue
        if compiled_only and not impl.compiled_on(platform):
            continue
        if with_custom_bwd is not None and impl.has_custom_bwd != with_custom_bwd:
            continue
        if precision is not None and impl.precision != precision:
            continue
        out.append(n)
    return out


def capabilities(kind: str, name: Optional[str] = None) -> Dict[str, Dict]:
    """Capability table for ``kind``: {name: {field: value}}, every field of
    :class:`KernelImpl` but the builder, plus ``platform_modes`` ({platform:
    "compiled" | "interpret" | None} over ``PLATFORMS``).  Pass ``name`` to
    restrict it to one impl (KeyError if unknown)."""
    kind = canonical_kind(kind)
    impls = (
        {name: get_impl(kind, name)}
        if name is not None
        else {n: i for (k, n), i in sorted(_REGISTRY.items()) if k == kind}
    )
    out = {}
    for n, impl in impls.items():
        row = {
            f.name: getattr(impl, f.name)
            for f in dataclasses.fields(KernelImpl)
            if f.name not in ("kind", "name", "builder")
        }
        row["platform_modes"] = {p: impl.platform_mode(p) for p in PLATFORMS}
        out[n] = row
    return out


def resolve(kind: str, name: str, spec: Any) -> Callable:
    """Bind impl ``name`` to ``spec``; memoised per (kind, name, spec)."""
    key = (canonical_kind(kind), name, spec)
    fn = _BIND_CACHE.get(key)
    if fn is None:
        fn = get_impl(kind, name).builder(spec)
        _BIND_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# built-in implementations
# ---------------------------------------------------------------------------

_CUDA = dict(needs_tables=True, platforms=("gpu",), interpret_only_on=("cpu",),
             uses_kernel=True, has_custom_bwd=True)


@register(KIND_TP, "ref", description="per-path dense-CG einsum chain (oracle)")
def _tp_ref_builder(spec):
    from repro_torch.core.channelwise_tp import tp_ref

    return partial(tp_ref, spec=spec)


@register(KIND_TP, "fused", needs_tables=True,
          description="sparse-table contributions and one-hot m3 matmul")
def _tp_fused_builder(spec):
    from repro_torch.core.channelwise_tp import build_tp_tables, tp_fused

    return partial(tp_fused, spec=spec, tables=build_tp_tables(spec))


@register(KIND_SYMCON, "ref", description="dense-U einsum per (L, nu) (oracle)")
def _symcon_ref_builder(spec):
    from repro_torch.core.symmetric_contraction import symcon_ref

    return partial(symcon_ref, spec=spec)


@register(KIND_SYMCON, "fused", needs_tables=True,
          description="sparse-path-table contraction and one-hot M matmul")
def _symcon_fused_builder(spec):
    from repro_torch.core.symmetric_contraction import build_symcon_tables, symcon_fused

    return partial(symcon_fused, spec=spec, tables=build_symcon_tables(spec))


# --- interaction: TP + receiver scatter + neighbor norm as one op ----------
# spec is ``core.interaction.InteractionSpec``; signature
#   fn(Y, h_node, R, senders, receivers, edge_mask, *, blocking=None) -> A


@register(KIND_INTERACTION, "ref",
          description="tp_ref -> [E,k,d_out] messages -> receiver sum (oracle)")
def _interaction_ref_builder(spec):
    from repro_torch.core.interaction import interaction_ref

    return partial(interaction_ref, spec=spec)


@register(KIND_INTERACTION, "fused", needs_tables=True,
          description="nnz-basis aggregation: no [E,k,d_out] message tensor")
def _interaction_fused_builder(spec):
    from repro_torch.core.channelwise_tp import build_tp_tables
    from repro_torch.core.interaction import interaction_fused

    return partial(interaction_fused, spec=spec, tables=build_tp_tables(spec.tp))


# --- the CUDA kernels, at each precision -----------------------------------
# The reduced-precision interaction builders put their precision on the
# spec, so one MaceConfig spec serves every variant.


def _register_cuda(precision: str) -> None:
    name = "cuda" if precision == "fp32" else f"cuda_{precision}"
    at = "" if precision == "fp32" else f" at {precision} operand precision, fp32 sums"

    @register(KIND_TP, name, precision=precision, **_CUDA,
              description=f"TP+scatter kernels under the identity blocking{at} "
                          "(fwd + bwd)")
    def _tp_cuda_builder(spec):
        from repro_torch.kernels.channelwise_tp.ops import tp_cuda

        return partial(tp_cuda, spec=spec, precision=precision)

    @register(KIND_SYMCON, name, precision=precision, **_CUDA,
              description=f"symmetric-contraction kernels{at} (fwd + bwd)")
    def _symcon_cuda_builder(spec):
        from repro_torch.kernels.symmetric_contraction.ops import symcon_cuda

        return partial(symcon_cuda, spec=spec, precision=precision)

    @register(KIND_INTERACTION, name, precision=precision, consumes_blocking=True,
              **_CUDA,
              description=f"fused TP+scatter kernel over pre-blocked edges{at}; "
                          "backward = blocked gather + TP-transpose kernel "
                          "(the identity-blocked kernels + receiver sum when "
                          "blocking is absent; bwd_impl='fused' selects the "
                          "fused formulation's VJP)")
    def _interaction_cuda_builder(spec):
        from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op

        if precision != "fp32":
            spec = dataclasses.replace(spec, precision=precision)
        return partial(interaction_cuda_op, spec=spec)


for _precision in ("fp32", "bf16", "fp8"):
    _register_cuda(_precision)
