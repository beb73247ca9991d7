"""Port parity, core math: the CG tables, spherical harmonics and radial
embedding of ``repro_torch`` against the JAX package on the same numpy
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channelwise_tp as jtp
from repro.core import radial as jradial
from repro.core import spherical as jsph
from repro.core import symmetric_contraction as jsc
from repro.core.irreps import LSpec as JLSpec
from repro_torch.core import channelwise_tp as ttp
from repro_torch.core import radial as tradial
from repro_torch.core import spherical as tsph
from repro_torch.core import symmetric_contraction as tsc
from repro_torch.core.irreps import LSpec as TLSpec


@pytest.mark.parametrize(
    "y_ls,h_ls,out_ls",
    [((0, 1, 2, 3), (0,), (0, 1, 2, 3)),
     ((0, 1, 2, 3), (0, 1), (0, 1, 2, 3)),
     ((0, 1, 2), (0, 1), (0, 1, 2))],
)
def test_tp_tables_match_jax(y_ls, h_ls, out_ls):
    want = jtp.build_tp_tables(jtp.TPSpec(JLSpec(y_ls), JLSpec(h_ls), JLSpec(out_ls)))
    got = ttp.build_tp_tables(ttp.TPSpec(TLSpec(y_ls), TLSpec(h_ls), TLSpec(out_ls)))
    for f in ("m1", "m2", "m3", "path"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.val, want.val)
    assert (got.dim_out, got.n_paths) == (want.dim_out, want.n_paths)


@pytest.mark.parametrize(
    "in_ls,out_ls,nu", [((0, 1, 2, 3), (0, 1), 2), ((0, 1, 2), (0, 1), 2),
                        ((0, 1, 2, 3), (0, 1), 1)]
)
def test_symcon_tables_match_jax(in_ls, out_ls, nu):
    want = jsc.build_symcon_tables(jsc.SymConSpec(JLSpec(in_ls), JLSpec(out_ls), nu))
    got = tsc.build_symcon_tables(tsc.SymConSpec(TLSpec(in_ls), TLSpec(out_ls), nu))
    assert len(got.entries) == len(want.entries)
    for g, w in zip(got.entries, want.entries):
        assert g[:2] == w[:2]
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(a, b)


def _vectors(seed=0, n=64):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    v[:4] = 0.0  # padded edges have exactly-zero vectors
    return v


@pytest.mark.parametrize("lmax", [1, 2, 3])
def test_spherical_harmonics_match_jax(lmax):
    v = _vectors(lmax)
    want = np.asarray(jsph.spherical_harmonics(lmax, jnp.asarray(v)))
    got = tsph.spherical_harmonics(lmax, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_spherical_harmonics_grad_finite_at_zero_vectors():
    v = torch.from_numpy(_vectors()).requires_grad_(True)
    tsph.spherical_harmonics(3, v).sum().backward()
    assert torch.isfinite(v.grad).all()


def test_radial_embedding_matches_jax():
    rng = np.random.default_rng(3)
    r = np.concatenate([[0.0, 1e-12, 4.5, 6.0], rng.uniform(0.1, 5.0, 60)]).astype(np.float32)
    want = np.asarray(jradial.radial_embedding(jnp.asarray(r), 4.5, 8))
    got = tradial.radial_embedding(torch.from_numpy(r), 4.5, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # beyond the cutoff the envelope vanishes exactly
    assert np.all(got[3] == 0.0)


def test_mlp_matches_jax():
    rng = np.random.default_rng(4)
    params = {
        "w0": rng.normal(size=(8, 16)).astype(np.float32),
        "b0": rng.normal(size=(16,)).astype(np.float32),
        "w1": rng.normal(size=(16, 5)).astype(np.float32),
        "b1": rng.normal(size=(5,)).astype(np.float32),
    }
    x = rng.normal(size=(10, 8)).astype(np.float32)
    want = np.asarray(jradial.apply_mlp({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(x)))
    got = tradial.apply_mlp({k: torch.from_numpy(v) for k, v in params.items()},
                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
