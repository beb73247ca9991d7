"""Port parity, symmetric contraction: the port's wrapper and autograd op
(plain versions on the CPU) against the JAX ``symcon_pallas`` kernels in
interpret mode, forward and gradients, on the same numpy inputs; and the
port's dense-U baseline ``symcon_ref`` against the JAX ``symcon_ref`` and
the port's ``symcon_cuda``.

Tolerances are the reference's own: 2e-5 for a kernel against its oracle
(tests/test_kernels.py), 2e-4 for gradients (tests/test_backward.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.irreps import lspec as jlspec
from repro.core.symmetric_contraction import SymConSpec as JSpec
from repro.core.symmetric_contraction import build_symcon_tables as jtables
from repro.core.symmetric_contraction import init_symcon_weights as jinit
from repro.core.symmetric_contraction import symcon_ref as jsymcon_ref
from repro.kernels.symmetric_contraction.kernel import (
    symcon_bwd_pallas_raw,
    symcon_pallas_raw,
)
from repro.kernels.symmetric_contraction.ops import symcon_pallas
from repro_torch.bridge import params_from_jax
from repro_torch.core.irreps import lspec as tlspec
from repro_torch.core.symmetric_contraction import SymConSpec as TSpec
from repro_torch.core.symmetric_contraction import symcon_ref
from repro_torch.kernels.symmetric_contraction.kernel import (
    p_total_of,
    symcon_bwd,
    symcon_fwd,
)
from repro_torch.kernels.symmetric_contraction.ops import symcon_cuda

N, K, N_SPECIES = 33, 8, 3


def _specs(nu, in_ls=(0, 1, 2, 3)):
    return (JSpec(jlspec(*in_ls), jlspec(0, 1), nu),
            TSpec(tlspec(*in_ls), tlspec(0, 1), nu))


def _inputs(nu, seed=0):
    jspec, tspec = _specs(nu)
    rng = np.random.default_rng(seed + nu)
    A = rng.normal(size=(N, K, jspec.in_spec.dim)).astype(np.float32)
    species = rng.integers(0, N_SPECIES, N).astype(np.int32)
    weights = {
        f"w_L{L}_nu{n}": rng.normal(size=shp).astype(np.float32)
        for (L, n), shp in jspec.weight_shapes(N_SPECIES, K).items()
    }
    G = rng.normal(size=(N, K, jspec.out_spec.dim)).astype(np.float32)
    return jspec, tspec, A, species, weights, G


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_forward_matches_jax_pallas(nu):
    jspec, tspec, A, species, weights, _ = _inputs(nu)
    want = symcon_pallas(jnp.asarray(A), jnp.asarray(species),
                         {k: jnp.asarray(v) for k, v in weights.items()},
                         jspec, block_n=8, interpret=True)
    got = symcon_cuda(torch.from_numpy(A), torch.from_numpy(species),
                      {k: torch.from_numpy(v) for k, v in weights.items()},
                      tspec, block_n=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_grads_match_jax_vjp(nu):
    jspec, tspec, A, species, weights, G = _inputs(nu, seed=10)

    def f(a, w):
        return symcon_pallas(a, jnp.asarray(species), w, jspec, block_n=8,
                             interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(A), {k: jnp.asarray(v) for k, v in weights.items()})
    dA_want, dW_want = vjp(jnp.asarray(G))

    A_t = torch.from_numpy(A).requires_grad_(True)
    W_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in weights.items()}
    B = symcon_cuda(A_t, torch.from_numpy(species), W_t, tspec, block_n=8)
    names = sorted(W_t)
    grads = torch.autograd.grad(B, [A_t] + [W_t[n] for n in names], torch.from_numpy(G))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(dA_want), rtol=2e-4, atol=2e-4)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(dW_want[n]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_kernel_layout_plain_versions_match_jax_raw_kernels(nu):
    """The plain versions the wrappers take on the CPU against the raw
    Pallas forward and backward kernels, in kernel layout (A irreps 0..2
    keep the interpret-mode backward quick)."""
    jspec, tspec = _specs(nu, in_ls=(0, 1, 2))
    rng = np.random.default_rng(20 + nu)
    P = p_total_of(tspec)
    A_t = rng.normal(size=(32, jspec.in_spec.dim, K)).astype(np.float32)
    W_t = rng.normal(size=(32, P, K)).astype(np.float32)
    G_t = rng.normal(size=(32, jspec.out_spec.dim, K)).astype(np.float32)
    tab = jtables(jspec)
    want = symcon_pallas_raw(jnp.asarray(A_t), jnp.asarray(W_t), jspec, tab,
                             block_n=8, interpret=True)
    got = symcon_fwd(torch.from_numpy(A_t), torch.from_numpy(W_t), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    dA_w, dW_w = symcon_bwd_pallas_raw(jnp.asarray(A_t), jnp.asarray(W_t),
                                       jnp.asarray(G_t), jspec, tab,
                                       block_n=8, interpret=True)
    dA, dW = symcon_bwd(torch.from_numpy(A_t), torch.from_numpy(W_t),
                        torch.from_numpy(G_t), tspec)
    np.testing.assert_allclose(dA.numpy(), np.asarray(dA_w), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dW.numpy(), np.asarray(dW_w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_ref_matches_jax_ref_and_the_port_op(nu):
    """The dense-U einsum baseline (``chip_smoke.py``'s library yardstick)
    computes what the JAX baseline and the port's op compute, with the JAX
    package's initial weights carried over by the parameter bridge."""
    jspec, tspec, A, species, _, _ = _inputs(nu, seed=30)
    jw = jinit(jax.random.PRNGKey(nu), jspec, N_SPECIES, K)
    tw = params_from_jax({k: np.asarray(v) for k, v in jw.items()})
    want = np.asarray(jsymcon_ref(jnp.asarray(A), jnp.asarray(species), jw, jspec))
    got = symcon_ref(torch.from_numpy(A), torch.from_numpy(species).long(), tw, tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    op = symcon_cuda(torch.from_numpy(A), torch.from_numpy(species), tw, tspec, block_n=8)
    np.testing.assert_allclose(got.numpy(), op.numpy(), rtol=2e-5, atol=2e-5)


def _symcon_first_order(create_graph):
    _, tspec, A, species, weights, _ = _inputs(2)
    A_t = torch.from_numpy(A).requires_grad_(True)
    B = symcon_cuda(A_t, torch.from_numpy(species),
                    {k: torch.from_numpy(v) for k, v in weights.items()}, tspec)
    (g,) = torch.autograd.grad(B.square().sum(), A_t, create_graph=create_graph)
    return A_t, g


def test_symcon_second_order_runs_through_the_plain_twin():
    A_t, g = _symcon_first_order(create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), A_t)
    assert torch.isfinite(gg).all() and float(gg.abs().max()) > 0


def test_symcon_wrapper_checks_inputs_and_refuses_grad_of_grad():
    """Input checks, and the refusal of a graph through the second order:
    the derivative of the grad-of-grad (a third order) raises.  The second
    order itself runs (test above)."""
    _, tspec, A, species, weights, _ = _inputs(2)
    P = p_total_of(tspec)
    with pytest.raises(ValueError):
        symcon_fwd(torch.zeros(4, 5, K), torch.zeros(4, P, K), tspec)
    with pytest.raises(TypeError):
        symcon_fwd(torch.zeros(4, 16, K, dtype=torch.float64),
                   torch.zeros(4, P, K), tspec)
    with pytest.raises(ValueError):
        symcon_fwd(torch.zeros(4, K, 16).transpose(1, 2), torch.zeros(4, P, K), tspec)
    A_t, g = _symcon_first_order(create_graph=True)
    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.autograd.grad(g.sum(), A_t, create_graph=True)
