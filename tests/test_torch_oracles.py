"""The port's oracle shims (``kernels/*/ref.py``, counterparts of the JAX
package's): each equals, bit for bit, the plain function it wraps, and the
JAX shim on the same numpy inputs within the kernel tolerance 2e-5
(tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.channelwise_tp import TPSpec as JTPSpec
from repro.core.interaction import InteractionSpec as JSpec
from repro.core.irreps import lspec as jlspec
from repro.core.irreps import sh_spec as jsh
from repro.core.symmetric_contraction import SymConSpec as JSymConSpec
from repro.kernels.channelwise_tp.ref import interaction_reference as jinteraction_reference
from repro.kernels.channelwise_tp.ref import tp_reference as jtp_reference
from repro.kernels.symmetric_contraction.ref import symcon_reference as jsymcon_reference
from repro_torch.core.channelwise_tp import TPSpec, tp_ref
from repro_torch.core.interaction import InteractionSpec, interaction_ref
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.core.symmetric_contraction import SymConSpec, symcon_ref
from repro_torch.kernels.channelwise_tp.ref import interaction_reference, tp_reference
from repro_torch.kernels.symmetric_contraction.ref import symcon_reference

TOL = dict(rtol=2e-5, atol=2e-5)
E, N, K = 40, 9, 4


def _tp_inputs(seed=0):
    rng = np.random.default_rng(seed)
    jt = JTPSpec(jsh(2), jlspec(0, 1), jlspec(0, 1, 2))
    tt = TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2))
    Y = rng.normal(size=(E, jt.y_spec.dim)).astype(np.float32)
    h = rng.normal(size=(N, K, jt.h_spec.dim)).astype(np.float32)
    R = rng.normal(size=(E, jt.n_paths, K)).astype(np.float32)
    snd = rng.integers(0, N, E).astype(np.int32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    return jt, tt, Y, h, R, snd, rcv, mask


def test_symcon_reference_is_symcon_ref():
    rng = np.random.default_rng(1)
    jspec, tspec = JSymConSpec(jlspec(0, 1, 2), jlspec(0, 1), 2), SymConSpec(
        lspec(0, 1, 2), lspec(0, 1), 2)
    A = rng.normal(size=(N, K, jspec.in_spec.dim)).astype(np.float32)
    species = rng.integers(0, 3, N).astype(np.int32)
    w = {f"w_L{L}_nu{n}": rng.normal(size=s).astype(np.float32)
         for (L, n), s in jspec.weight_shapes(3, K).items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = symcon_reference(torch.from_numpy(A), torch.from_numpy(species).long(), tw, tspec)
    want = symcon_ref(torch.from_numpy(A), torch.from_numpy(species).long(), tw, tspec)
    assert torch.equal(got, want)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jsymcon_reference(jnp.asarray(A), jnp.asarray(species), jw, jspec)), **TOL)


def test_tp_reference_is_tp_ref():
    jt, tt, Y, h, R, snd, _, _ = _tp_inputs()
    args = (torch.from_numpy(Y), torch.from_numpy(h[snd]), torch.from_numpy(R))
    got = tp_reference(*args, tt)
    assert torch.equal(got, tp_ref(*args, tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jtp_reference(jnp.asarray(Y), jnp.asarray(h[snd]), jnp.asarray(R), jt)), **TOL)


def test_interaction_reference_is_interaction_ref():
    jt, tt, Y, h, R, snd, rcv, mask = _tp_inputs(2)
    jspec, tspec = JSpec(jt, 3.0, 8), InteractionSpec(tt, 3.0, 8)
    targs = [torch.from_numpy(a) for a in (Y, h, R, snd, rcv, mask)]
    got = interaction_reference(*targs, tspec)
    assert torch.equal(got, interaction_ref(*targs, spec=tspec))
    np.testing.assert_allclose(got.numpy(), np.asarray(jinteraction_reference(
        *[jnp.asarray(a) for a in (Y, h, R, snd, rcv, mask)], jspec)), **TOL)
