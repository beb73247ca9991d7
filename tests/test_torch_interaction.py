"""Port parity, interaction op: the blocked TP+scatter autograd op of the
port (plain versions on the CPU) against the JAX ``interaction_pallas`` in
interpret mode, forward and gradients (dY, dh, dR), including atoms with
no edges and a hub atom whose edges spill over several tiles.

Tolerances are the reference's own: 2e-5 for a kernel against its oracle
(tests/test_kernels.py), 2e-4 for gradients (tests/test_backward.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channelwise_tp import TPSpec as JTPSpec
from repro.core.channelwise_tp import build_tp_tables as jtables
from repro.core.interaction import InteractionSpec as JSpec
from repro.core.irreps import lspec as jlspec
from repro.core.irreps import sh_spec as jsh
from repro.data.blocking import block_edges as jblock_edges
from repro.kernels.channelwise_tp.kernel import tp_bwd_pallas_raw, tp_scatter_pallas_raw
from repro.kernels.channelwise_tp.ops import interaction_pallas
from repro_torch.core.channelwise_tp import TPSpec as TTPSpec
from repro_torch.core.interaction import InteractionSpec as TSpec
from repro_torch.core.irreps import lspec as tlspec
from repro_torch.core.irreps import sh_spec as tsh
from repro_torch.data.blocking import block_edges, blocking_from_batch, blocking_to_batch
from repro_torch.kernels.channelwise_tp.kernel import tp_gather_bwd, tp_scatter
from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op

AVG = 4.0


def _specs(lmax, h_ls, out_ls, block_n):
    j = JSpec(JTPSpec(jsh(lmax), jlspec(*h_ls), jlspec(*out_ls)), AVG, block_n)
    t = TSpec(TTPSpec(tsh(lmax), tlspec(*h_ls), tlspec(*out_ls)), AVG, block_n)
    return j, t


def _operands(rng, E, n_atoms, k, jspec):
    Y = rng.normal(size=(E, jspec.tp.y_spec.dim)).astype(np.float32)
    h = rng.normal(size=(n_atoms, k, jspec.tp.h_spec.dim)).astype(np.float32)
    R = rng.normal(size=(E, jspec.tp.n_paths, k)).astype(np.float32)
    G = rng.normal(size=(n_atoms, k, jspec.tp.out_spec.dim)).astype(np.float32)
    return Y, h, R, G


CASES = {
    # random receivers, some masked edges, padding tiles
    "random": dict(lmax=2, h_ls=(0, 1), out_ls=(0, 1, 2), E=96, n_atoms=21, k=4,
                   block_n=8, block_e=16),
    # atoms with no edges + one hub atom spanning three tiles with one base
    "empty_and_hub": dict(lmax=2, h_ls=(0,), out_ls=(0, 1, 2), E=64, n_atoms=16,
                          k=4, block_n=8, block_e=16),
}


def _case(name, seed=0):
    c = CASES[name]
    rng = np.random.default_rng(seed)
    jspec, tspec = _specs(c["lmax"], c["h_ls"], c["out_ls"], c["block_n"])
    E, n_atoms, k = c["E"], c["n_atoms"], c["k"]
    Y, h, R, G = _operands(rng, E, n_atoms, k, jspec)
    senders = rng.integers(0, n_atoms, E).astype(np.int32)
    if name == "random":
        receivers = rng.integers(0, n_atoms, E).astype(np.int32)
        edge_mask = rng.random(E) < 0.9
    else:
        receivers = np.concatenate([np.full(48, 3), np.full(16, 11)]).astype(np.int32)
        edge_mask = np.ones(E, bool)
    jb = jblock_edges(receivers, edge_mask, n_atoms,
                      block_n=c["block_n"], block_e=c["block_e"])
    tb = block_edges(receivers, edge_mask, n_atoms,
                     block_n=c["block_n"], block_e=c["block_e"])
    for a, b in ((jb.perm, tb.perm), (jb.valid, tb.valid),
                 (jb.local_rcv, tb.local_rcv), (jb.tile_base, tb.tile_base)):
        np.testing.assert_array_equal(a, b)
    if name == "empty_and_hub":
        assert (tb.tile_base == 0).sum() == 3
    return dict(jspec=jspec, tspec=tspec, Y=Y, h=h, R=R, G=G, senders=senders,
                receivers=receivers, edge_mask=edge_mask, jb=jb, tb=tb)


def _torch_blocking(tb):
    arrays = blocking_from_batch(blocking_to_batch(tb))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _jax_fn(c):
    def f(Y, h, R):
        return interaction_pallas(
            Y, h, R, jnp.asarray(c["senders"]), jnp.asarray(c["receivers"]),
            jnp.asarray(c["edge_mask"]), c["jb"], c["jspec"], interpret=True,
        )
    return f


def _torch_call(c, Y, h, R):
    return interaction_cuda_op(
        Y, h, R, torch.from_numpy(c["senders"]), torch.from_numpy(c["receivers"]),
        torch.from_numpy(c["edge_mask"]), spec=c["tspec"],
        blocking=_torch_blocking(c["tb"]),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_interaction_forward_matches_jax_pallas(name):
    c = _case(name)
    want = _jax_fn(c)(jnp.asarray(c["Y"]), jnp.asarray(c["h"]), jnp.asarray(c["R"]))
    got = _torch_call(c, torch.from_numpy(c["Y"]), torch.from_numpy(c["h"]),
                      torch.from_numpy(c["R"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    if name == "empty_and_hub":
        # atoms that receive no edge get exact zeros
        silent = np.setdiff1d(np.arange(c["h"].shape[0]), c["receivers"])
        assert np.all(got.numpy()[silent] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_interaction_grads_match_jax_vjp(name):
    c = _case(name, seed=1)
    _, vjp = jax.vjp(_jax_fn(c), jnp.asarray(c["Y"]), jnp.asarray(c["h"]),
                     jnp.asarray(c["R"]))
    want = vjp(jnp.asarray(c["G"]))
    ins = [torch.from_numpy(c[n]).requires_grad_(True) for n in ("Y", "h", "R")]
    A = _torch_call(c, *ins)
    got = torch.autograd.grad(A, ins, torch.from_numpy(c["G"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_interaction_kernel_layout_plain_versions_match_jax_raw_kernels():
    """The plain versions the wrappers take on the CPU against the raw
    Pallas kernels, on slot-layout operands with masked slots and fully
    masked padding tiles."""
    c = _case("random", seed=2)
    tb, jspec, tspec = c["tb"], c["jspec"], c["tspec"]
    rng = np.random.default_rng(3)
    E_p, T, bn = tb.perm.shape[0], tb.n_atom_tiles, tb.block_n
    k = c["h"].shape[1]
    Y_b = rng.normal(size=(E_p, jspec.tp.y_spec.dim)).astype(np.float32)
    h_b = rng.normal(size=(E_p, jspec.tp.h_spec.dim, k)).astype(np.float32)
    R_b = rng.normal(size=(E_p, jspec.tp.n_paths, k)).astype(np.float32)
    G_t = rng.normal(size=(T * bn, jspec.tp.out_spec.dim, k)).astype(np.float32)
    assert not tb.valid[-tb.epb:].any()  # the last tile is padding
    lr = jnp.asarray(tb.local_rcv)[:, None]
    em = jnp.asarray(tb.valid, jnp.float32)[:, None]
    jt = jtables(jspec.tp)
    want = tp_scatter_pallas_raw(jnp.asarray(Y_b), jnp.asarray(h_b), jnp.asarray(R_b),
                                 lr, em, jspec.tp, jt, n_atom_tiles=T, block_n=bn,
                                 block_e=tb.epb, interpret=True)
    tt = dict(n_tiles=T, block_n=bn)
    ops = [torch.from_numpy(a) for a in (Y_b, h_b, R_b)] + [
        torch.from_numpy(tb.local_rcv), torch.from_numpy(tb.valid)]
    got = tp_scatter(*ops, tspec.tp, **tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.all(got.numpy()[-bn:] == 0.0)
    want_b = tp_bwd_pallas_raw(jnp.asarray(G_t), jnp.asarray(Y_b), jnp.asarray(h_b),
                               jnp.asarray(R_b), lr, em, jspec.tp, jt, n_atom_tiles=T,
                               block_n=bn, block_e=tb.epb, interpret=True)
    got_b = tp_gather_bwd(torch.from_numpy(G_t), *ops, tspec.tp, **tt)
    for g, w in zip(got_b, want_b):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
        assert np.all(g.numpy()[~tb.valid] == 0.0)


def test_interaction_wrappers_check_inputs():
    c = _case("random")
    bad = dict(_torch_blocking(c["tb"]))
    bad["perm"] = bad["perm"][:-1]
    with pytest.raises(ValueError, match="blocking"):
        interaction_cuda_op(torch.from_numpy(c["Y"]), torch.from_numpy(c["h"]),
                            torch.from_numpy(c["R"]), torch.from_numpy(c["senders"]),
                            torch.from_numpy(c["receivers"]),
                            torch.from_numpy(c["edge_mask"]), spec=c["tspec"],
                            blocking=bad)
    E_p = c["tb"].perm.shape[0]
    k = c["h"].shape[1]
    tp = c["tspec"].tp
    good = [torch.zeros(E_p, tp.y_spec.dim), torch.zeros(E_p, tp.h_spec.dim, k),
            torch.zeros(E_p, tp.n_paths, k), torch.zeros(E_p, dtype=torch.int32),
            torch.zeros(E_p, dtype=torch.bool)]
    with pytest.raises(TypeError):
        tp_scatter(*good[:3], good[3].long(), good[4], tp, n_tiles=6, block_n=8)
    with pytest.raises(ValueError):
        tp_scatter(*good, tp, n_tiles=7, block_n=8)
    with pytest.raises(ValueError):
        tp_scatter(good[0], good[1], good[2][:, :1], *good[3:], tp, n_tiles=6, block_n=8)
