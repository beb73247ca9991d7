"""Port parity, the kernel registry: the port's impl lists, capability table
and filters against the JAX package's under the name map of
``repro_torch.bridge`` (``pallas`` -> ``cuda``, ``uses_pallas`` ->
``uses_kernel``, the TPU -> the GPU), and ``resolve_interaction``'s
fallback to a TP-only impl against the JAX oracle on the same inputs.

Tolerance: 2e-5, the reference's for an impl against its oracle
(tests/test_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channelwise_tp import TPSpec as JTPSpec
from repro.core.interaction import InteractionSpec as JSpec
from repro.core.irreps import lspec as jlspec
from repro.core.irreps import sh_spec as jsh
from repro.kernels import registry as jreg
from repro_torch.bridge import JAX_CAPABILITY_FIELDS, JAX_IMPL_NAMES, JAX_PLATFORMS
from repro_torch.core.channelwise_tp import TPSpec, tp_ref
from repro_torch.core.interaction import InteractionSpec, resolve_interaction
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.kernels import registry
from repro_torch.kernels.precision import PRECISIONS

KINDS = ("channelwise_tp", "symcon", "interaction")
MODE_RANK = {None: 0, "interpret": 1, "compiled": 2}


def _mapped(names):
    return sorted(JAX_IMPL_NAMES[n] for n in names)


@pytest.mark.parametrize("kind", KINDS)
def test_registry_lists_every_jax_impl_under_the_port_names(kind):
    assert registry.available(kind) == _mapped(jreg.available(kind))
    assert set(registry.available(kind)) == {"cuda", "cuda_bf16", "cuda_fp8", "fused", "ref"}


@pytest.mark.parametrize("kind", KINDS)
def test_capabilities_match_jax_under_the_name_map(kind):
    """Every capability of every impl, the JAX field and platform names
    mapped; a port platform takes the best mode of the JAX platforms that
    map onto it (the GPU stands for both the JAX GPU and TPU rows)."""
    ours, theirs = registry.capabilities(kind), jreg.capabilities(kind)
    assert sorted(ours) == _mapped(theirs)
    for jname, jrow in theirs.items():
        row = ours[JAX_IMPL_NAMES[jname]]
        for field, value in jrow.items():
            if field in ("description", "platform_modes"):
                continue
            port_field = JAX_CAPABILITY_FIELDS.get(field, field)
            if field in ("platforms", "interpret_only_on"):
                assert sorted(row[port_field]) == sorted({JAX_PLATFORMS[p] for p in value}), (
                    jname, field)
            else:
                assert row[port_field] == value, (jname, field)
        for platform in registry.PLATFORMS:
            modes = [m for p, m in jrow["platform_modes"].items()
                     if JAX_PLATFORMS[p] == platform]
            assert row["platform_modes"][platform] == max(modes, key=MODE_RANK.get), (
                jname, platform)
    assert set(ours["cuda"]) == {f.name for f in dataclasses.fields(
        registry.KernelImpl)} - {"kind", "name", "builder"} | {"platform_modes"}


@pytest.mark.parametrize("kind", KINDS)
def test_available_filters_partition_as_jax(kind):
    for p in PRECISIONS:
        assert registry.available(kind, precision=p) == _mapped(
            jreg.available(kind, precision=p))
    assert registry.available(kind, precision="bf16") == ["cuda_bf16"]
    assert registry.available(kind, precision="fp8") == ["cuda_fp8"]
    for flag in (True, False):
        assert registry.available(kind, with_custom_bwd=flag) == _mapped(
            jreg.available(kind, with_custom_bwd=flag))
    # the CPU runs the cuda impls through their plain versions, as the JAX
    # package runs Pallas in interpret mode: supported, never a candidate
    assert registry.available(kind, "cpu") == _mapped(jreg.available(kind, "cpu"))
    assert registry.available(kind, "cpu", compiled_only=True) == _mapped(
        jreg.available(kind, "cpu", compiled_only=True)) == ["fused", "ref"]
    assert registry.available(kind, "gpu", compiled_only=True) == _mapped(
        jreg.available(kind, "tpu", compiled_only=True))
    with pytest.raises(ValueError):
        registry.available(kind, compiled_only=True)


def test_registry_lists_interaction_impls():
    """Port of tests/test_interaction.py::test_registry_lists_interaction_impls."""
    assert {"ref", "fused", "cuda"} <= set(registry.available("interaction"))
    impl = registry.get_impl("interaction", "cuda")
    assert impl.consumes_blocking and "cpu" in impl.interpret_only_on
    assert impl.uses_kernel and impl.has_custom_bwd
    fused = registry.get_impl("interaction", "fused")
    assert not fused.consumes_blocking and not fused.uses_kernel
    assert not fused.has_custom_bwd
    assert registry.canonical_kind("tp_scatter") == "interaction"
    assert registry.canonical_kind("tp") == "channelwise_tp"
    assert registry.canonical_kind("symmetric_contraction") == "symcon"
    with pytest.raises(KeyError):
        registry.canonical_kind("no_such_kind")


def test_register_refuses_a_duplicate_and_unregister_drops_the_binding():
    spec = TPSpec(sh_spec(1), lspec(0), lspec(0, 1))

    @registry.register("tp", "dup_test_impl")
    def _build(s):
        return lambda Y, h, R: tp_ref(Y, h, R, s)

    try:
        fn = registry.resolve("channelwise_tp", "dup_test_impl", spec)
        assert registry.resolve("tp", "dup_test_impl", spec) is fn  # memoised
        with pytest.raises(ValueError, match="already registered"):
            registry.register("channelwise_tp", "dup_test_impl")(_build)
        registry.register("channelwise_tp", "dup_test_impl", overwrite=True)(_build)
        assert registry.resolve("channelwise_tp", "dup_test_impl", spec) is not fn
    finally:
        registry.unregister("channelwise_tp", "dup_test_impl")
    with pytest.raises(KeyError):
        registry.get_impl("channelwise_tp", "dup_test_impl")


def _interaction_inputs(seed, E, n_atoms, k, spec):
    rng = np.random.default_rng(seed)
    tp = spec.tp
    return (rng.normal(size=(E, tp.y_spec.dim)).astype(np.float32),
            rng.normal(size=(n_atoms, k, tp.h_spec.dim)).astype(np.float32),
            rng.normal(size=(E, tp.n_paths, k)).astype(np.float32),
            rng.integers(0, n_atoms, E).astype(np.int32),
            rng.integers(0, n_atoms, E).astype(np.int32),
            rng.random(E) < 0.9)


def test_tp_only_registered_impl_falls_back_to_wrapped_aggregation():
    """Port of tests/test_interaction.py::test_tp_only_registered_impl_falls_
    back_to_wrapped_aggregation: a kernel registered only under
    ``channelwise_tp`` stays usable as an interaction impl, against the JAX
    ``interaction/ref`` on the same inputs."""
    jspec = JSpec(JTPSpec(jsh(2), jlspec(0, 1), jlspec(0, 1, 2)), 4.0, 8)
    spec = InteractionSpec(TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2)), 4.0, 8)

    @registry.register("channelwise_tp", "tp_only_test_impl", platforms=("cpu",))
    def _build(s):
        return lambda Y, h_send, R: tp_ref(Y, h_send, R, s)

    args = _interaction_inputs(3, 48, 13, 4, spec)
    try:
        got = resolve_interaction("tp_only_test_impl", spec)(*map(torch.from_numpy, args))
    finally:
        registry.unregister("channelwise_tp", "tp_only_test_impl")
    want = jreg.resolve("interaction", "ref", jspec)(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(KeyError):
        resolve_interaction("no_such_impl_anywhere", spec)
    # a name of the interaction kind resolves there, not through the fallback
    assert resolve_interaction("fused", spec) is registry.resolve("interaction", "fused", spec)


@pytest.mark.parametrize("name", ["ref", "fused", "cuda"])
def test_interaction_impls_match_the_jax_impl_of_the_mapped_name(name):
    """Each interaction impl of the port (plain versions on the CPU) against
    the JAX impl it maps from (Pallas in interpret mode), unblocked."""
    jname = {v: k for k, v in JAX_IMPL_NAMES.items()}[name]
    jspec = JSpec(JTPSpec(jsh(2), jlspec(0, 1), jlspec(0, 1, 2)), 4.0, 8)
    spec = InteractionSpec(TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2)), 4.0, 8)
    args = _interaction_inputs(4, 40, 11, 4, spec)
    want = jax.jit(jreg.resolve("interaction", jname, jspec))(*map(jnp.asarray, args))
    got = registry.resolve("interaction", name, spec)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
