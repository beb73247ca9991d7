"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and ``nvcc`` and skip without one
(``python -m pytest -m gpu tests/test_torch_cuda.py`` on a GPU machine).
Imports no JAX, so it runs where only PyTorch is installed.  Tolerance:
2e-5 of the output's largest magnitude, the reference's kernel-vs-oracle
bound; the kernels sum in another order than the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.core.symmetric_contraction import SymConSpec
from repro_torch.data.blocking import block_edges
from repro_torch.kernels.channelwise_tp import kernel as tpk
from repro_torch.kernels.symmetric_contraction import kernel as sck

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-5 * scale


def _randn(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_kernels_match_plain(dev, nu):
    rng = np.random.default_rng(nu)
    spec = SymConSpec(lspec(0, 1, 2, 3), lspec(0, 1), nu)
    N, k = 40, 24  # N * k not a multiple of the block size
    A, W, G = (_randn(rng, dev, N, 16, k), _randn(rng, dev, N, sck.p_total_of(spec), k),
               _randn(rng, dev, N, 4, k))
    before = sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches
    _close([sck.symcon_fwd(A, W, spec)], [sck.symcon_plain(A, W, spec)])
    _close(sck.symcon_bwd(A, W, G, spec), sck.symcon_bwd_plain(A, W, G, spec))
    torch.cuda.synchronize()
    assert (sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("h_ls,k", [((0,), 8), ((0, 1), 40)])
def test_tp_kernels_match_plain_with_hub_and_padding(dev, h_ls, k):
    rng = np.random.default_rng(len(h_ls))
    spec = TPSpec(sh_spec(3), lspec(*h_ls), lspec(0, 1, 2, 3))
    n_atoms, E = 20, 160
    receivers = np.concatenate([np.full(40, 3), rng.integers(0, n_atoms, E - 40)])
    mask = rng.random(E) < 0.9
    blk = block_edges(receivers.astype(np.int32), mask, n_atoms, block_n=8, block_e=16)
    assert not blk.valid[-16:].any()
    E_p, T = blk.perm.shape[0], blk.n_atom_tiles
    local = torch.from_numpy(blk.local_rcv).to(dev)
    valid = torch.from_numpy(blk.valid).to(dev)
    Y = _randn(rng, dev, E_p, 16)
    h = _randn(rng, dev, E_p, spec.h_spec.dim, k)
    R = _randn(rng, dev, E_p, spec.n_paths, k)
    G = _randn(rng, dev, T * 8, 16, k)
    kw = dict(n_tiles=T, block_n=8)
    out = tpk.tp_scatter(Y, h, R, local, valid, spec, **kw)
    _close([out], [tpk.tp_scatter_plain(Y, h, R, local, valid, spec, **kw)])
    assert float(out[-8:].abs().max()) == 0.0  # padding tile stays exactly zero
    got = tpk.tp_gather_bwd(G, Y, h, R, local, valid, spec, **kw)
    _close(got, tpk.tp_gather_bwd_plain(G, Y, h, R, local, valid, spec, **kw))
    for g in got:
        assert float(g[~valid].abs().max()) == 0.0  # masked slots: exact zeros


def test_wrappers_refuse_cpu_cuda_mix(dev):
    spec = SymConSpec(lspec(0, 1), lspec(0, 1), 2)
    A = torch.zeros(8, 4, 8, device=dev)
    with pytest.raises(ValueError):
        sck.symcon_fwd(A, torch.zeros(8, sck.p_total_of(spec), 8), spec)
