"""Port parity, the model: the parameter bridge, ``mace_energy_forces`` of
the port (plain versions on the CPU) against the JAX model with the Pallas
kernels in interpret mode on one collated, blocked batch, and the port's
rotation invariance and force equivariance.

Tolerances: energies rtol 2e-4 / atol 2e-5 and forces 2e-4, the reference's
own for impl parity and gradients (tests/test_kernels.py,
tests/test_backward.py); invariance bounds as in tests/test_mace.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mace_cfm import CONFIG as JCONFIG
from repro.core.mace import MaceConfig as JConfig
from repro.core.mace import init_mace as jinit
from repro.core.mace import mace_energy_forces as jforces
from repro.data.collate import BinShape as JBinShape
from repro.data.collate import collate_bin as jcollate
from repro.train.checkpoint import _flatten
from repro_torch.bridge import JAX_BWD_IMPL_NAMES, params_from_jax, params_to_numpy
from repro_torch.configs.mace_cfm import CONFIG as TCONFIG
from repro_torch.core import cg as tcg
from repro_torch.core.mace import MaceConfig as TConfig
from repro_torch.core.mace import init_mace as tinit
from repro_torch.core.mace import mace_energy_forces as tforces
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.data.molecules import SyntheticCFMDataset

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
JCFG = JConfig(**WIDTHS, impl="pallas", interaction_impl="pallas",
               interaction_bwd_impl="pallas", precision="fp32")
TCFG = TConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
SHAPE = dict(max_nodes=48, max_edges=1152, max_graphs=4, block_n=8, block_e=32)


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), JCFG))


@functools.lru_cache(maxsize=None)
def _batch():
    ds = SyntheticCFMDataset(24, seed=3, max_atoms=20)
    mols, n = [], 0
    for i in range(len(ds)):
        m = ds.get(i)
        if m.n_edges and n + m.n_atoms <= 40 and len(mols) < 3:
            mols.append(m)
            n += m.n_atoms
    jb = jcollate(mols, JBinShape(**SHAPE), strict=True, with_blocking=True)
    tb = collate_bin(mols, BinShape(**SHAPE), strict=True, with_blocking=True)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    return tb, len(mols)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_params_from_jax_round_trip():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    want = _flatten(jp)
    got = params_to_numpy(params_from_jax(jax.tree.map(np.asarray, jp)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # a flat tree keyed by checkpoint paths bridges the same way
    again = params_to_numpy(params_from_jax(want))
    assert all(np.array_equal(again[k], want[k]) for k in want)


def test_port_init_has_jax_keys_and_shapes():
    want = _flatten(jinit(jax.random.PRNGKey(0), JCFG))
    got = params_to_numpy(tinit(TCFG, torch.Generator().manual_seed(0)))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)


def test_port_config_has_the_jax_config_widths():
    ours = {f.name: getattr(TCONFIG, f.name) for f in dataclasses.fields(TCONFIG)}
    theirs = {f.name: getattr(JCONFIG, f.name) for f in dataclasses.fields(JCONFIG)}
    # the one JAX-only field is the dtype, which stays at float32 there
    assert theirs.keys() - ours.keys() == {"dtype"} and ours.keys() <= theirs.keys()
    assert np.dtype(theirs["dtype"]) == np.float32
    for name in ours.keys() - {"impl", "interaction_impl", "interaction_bwd_impl"}:
        assert ours[name] == theirs[name], name
    # the backward knob under the port's names
    assert ours["interaction_bwd_impl"] == JAX_BWD_IMPL_NAMES[theirs["interaction_bwd_impl"]]


def test_config_refuses_auto_until_the_autotuner_is_ported():
    """With the autotuner ported, ``"auto"`` is refused only where the JAX
    config refuses it: a raw forward resolving ``impl="auto"``; a raw
    ``interaction_impl="auto"`` follows ``impl``."""
    from repro_torch.kernels.registry import resolve

    cfg, jcfg = TConfig(impl="auto"), JConfig(impl="auto")
    assert cfg.symcon_impl_name == jcfg.symcon_impl_name == "auto"
    with pytest.raises(KeyError, match="auto"):
        resolve("symcon", cfg.symcon_impl_name, cfg.symcon_spec())
    for impl in ("fused", "ref"):
        assert (TConfig(impl=impl, interaction_impl="auto").interaction_impl_name
                == JConfig(impl=impl, interaction_impl="auto").interaction_impl_name == impl)


def test_energy_forces_match_jax_pallas():
    batch, n_graphs = _batch()
    G = SHAPE["max_graphs"]
    jp = _jax_params(1)
    e_want, f_want = jax.jit(lambda p, b: jforces(p, JCFG, b, G))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    e_got, f_got = tforces(params_from_jax(jp), TCFG, _torch_batch(batch), G)
    assert np.abs(np.asarray(e_want)[:n_graphs]).min() > 0
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want), rtol=2e-4, atol=2e-4)
    assert np.abs(f_got.numpy()).max() > 1e-3


def _rotated(batch, R):
    out = dict(batch)
    out["positions"] = (batch["positions"].astype(np.float64) @ R.T).astype(np.float32)
    return out


def test_rotation_invariance_of_energy():
    batch, _ = _batch()
    params = tinit(TCFG, torch.Generator().manual_seed(2))
    R = tcg.random_rotation(seed=42)
    G = SHAPE["max_graphs"]
    e0, _ = tforces(params, TCFG, _torch_batch(batch), G)
    e1, _ = tforces(params, TCFG, _torch_batch(_rotated(batch, R)), G)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-4, atol=2e-5)


def test_force_equivariance():
    batch, _ = _batch()
    params = tinit(TCFG, torch.Generator().manual_seed(3))
    R = tcg.random_rotation(seed=17)
    G = SHAPE["max_graphs"]
    _, f0 = tforces(params, TCFG, _torch_batch(batch), G)
    _, f1 = tforces(params, TCFG, _torch_batch(_rotated(batch, R)), G)
    np.testing.assert_allclose(
        f1.numpy(), (f0.numpy().astype(np.float64) @ R.T), rtol=2e-4, atol=2e-4
    )


def _energy_gradient(create_graph=True):
    from repro_torch.core.mace import mace_energy
    from repro_torch.data.blocking import blocking_from_batch

    batch, _ = _batch()
    params = tinit(TCFG, torch.Generator().manual_seed(4))
    tb = _torch_batch(batch)
    pos = tb["positions"].clone().requires_grad_(True)
    energy = mace_energy(params, TCFG, tb["species"], pos, tb["node_mask"],
                         tb["senders"], tb["receivers"], tb["edge_mask"],
                         tb["graph_id"], SHAPE["max_graphs"],
                         blocking=blocking_from_batch(tb))
    (grad,) = torch.autograd.grad(energy.sum(), pos, create_graph=create_graph)
    return pos, grad


def test_second_order_of_the_energy_runs_through_the_kernel_ops():
    """Training's forces term: a derivative of the forces, through the
    kernel ops' plain twins."""
    pos, grad = _energy_gradient()
    (hess,) = torch.autograd.grad(grad.square().sum(), pos)
    assert torch.isfinite(hess).all() and float(hess.abs().max()) > 0


def test_forces_run_under_no_grad_and_refuse_grad_of_grad():
    """Serving's forces run under ``no_grad`` and come out detached; a graph
    through the second order (a third order) is refused.  The second order
    itself runs (test above)."""
    batch, _ = _batch()
    params = tinit(TCFG, torch.Generator().manual_seed(4))
    with torch.no_grad():
        e, f = tforces(params, TCFG, _torch_batch(batch), SHAPE["max_graphs"])
    assert torch.isfinite(e).all() and torch.isfinite(f).all()
    assert not e.requires_grad and not f.requires_grad
    pos, grad = _energy_gradient()
    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.autograd.grad(grad.square().sum(), pos, create_graph=True)
