"""Port parity, second order: the kernel ops' derivatives of their backward
(the grad-of-grad a training step with forces takes), the plain twins the
second-order rules differentiate, and the weighted loss with its parameter
gradients, against the JAX package on the same numpy inputs.  JAX runs its
Pallas kernels in interpret mode; the port runs its plain versions (CPU
tensors).

Tolerances are the reference's: 2e-4 for gradients (tests/test_backward.py),
2e-5 for a formulation against its oracle (tests/test_kernels.py), loss
2e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channelwise_tp import TPSpec as JTPSpec
from repro.core.channelwise_tp import tp_fused as jtp_fused
from repro.core.channelwise_tp import tp_ref as jtp_ref
from repro.core.interaction import InteractionSpec as JISpec
from repro.core.interaction import interaction_fused as jint_fused
from repro.core.interaction import interaction_ref as jint_ref
from repro.core.irreps import lspec as jlspec
from repro.core.irreps import sh_spec as jsh
from repro.core.mace import MaceConfig as JConfig
from repro.core.mace import init_mace as jinit
from repro.core.mace import weighted_loss as jloss
from repro.core.symmetric_contraction import SymConSpec as JSpec
from repro.data.collate import BinShape as JBinShape
from repro.data.collate import collate_bin as jcollate
from repro.kernels.channelwise_tp.ops import _blocked_bwd_op, _tp_bwd_op, interaction_pallas_op
from repro.kernels.symmetric_contraction.ops import _symcon_bwd_op, symcon_pallas
from repro.train.checkpoint import _flatten
from repro_torch.bridge import flatten, params_from_jax
from repro_torch.core.channelwise_tp import TPSpec as TTPSpec
from repro_torch.core.channelwise_tp import tp_fused, tp_ref
from repro_torch.core.interaction import InteractionSpec as TISpec
from repro_torch.core.interaction import interaction_fused, interaction_ref
from repro_torch.core.irreps import lspec as tlspec
from repro_torch.core.irreps import sh_spec as tsh
from repro_torch.core.mace import MaceConfig as TConfig
from repro_torch.core.mace import energy_forces_graph, mace_energy_forces, param_count
from repro_torch.core.mace import weighted_loss as tloss
from repro_torch.core.symmetric_contraction import SymConSpec as TSpec
from repro_torch.data.blocking import block_edges
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.kernels.channelwise_tp import ops as tp_ops
from repro_torch.kernels.symmetric_contraction.kernel import (
    p_total_of,
    symcon_dbl_plain,
    symcon_plain,
)
from repro_torch.kernels.symmetric_contraction.ops import _SymconBwdOp, symcon_cuda

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
TWIN_TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# symmetric contraction
# ---------------------------------------------------------------------------

N_SC, K_SC, N_SPECIES = 32, 8, 3


def _symcon_case(nu, seed):
    jspec = JSpec(jlspec(0, 1, 2, 3), jlspec(0, 1), nu)
    tspec = TSpec(tlspec(0, 1, 2, 3), tlspec(0, 1), nu)
    rng = np.random.default_rng(seed)
    P, d_in, d_out = p_total_of(tspec), tspec.in_spec.dim, tspec.out_spec.dim
    arrays = {name: rng.normal(size=shape).astype(np.float32) for name, shape in (
        ("A", (N_SC, d_in, K_SC)), ("W", (N_SC, P, K_SC)), ("G", (N_SC, d_out, K_SC)),
        ("cA", (N_SC, d_in, K_SC)), ("cW", (N_SC, P, K_SC)))}
    return jspec, tspec, arrays


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_bwd_op_second_order_matches_jax(nu):
    """d/d(A, W, G) of <c, (dA, dW)> for the backward op: the JAX
    ``_symcon_bwd_op`` (Pallas first order, XLA twin second order) against
    ``_SymconBwdOp`` (plain first order here, ``symcon_plain`` twin)."""
    jspec, tspec, x = _symcon_case(nu, seed=10 + nu)

    def jscalar(a, w, g):
        dA, dW = _symcon_bwd_op(jspec, 8, True, "fp32", a, w, g)
        return jnp.sum(dA * x["cA"]) + jnp.sum(dW * x["cW"])

    want = jax.grad(jscalar, argnums=(0, 1, 2))(x["A"], x["W"], x["G"])
    ins = [_t(x[n], grad=True) for n in ("A", "W", "G")]
    dA, dW = _SymconBwdOp.apply(*ins, tspec)
    got = torch.autograd.grad((dA * _t(x["cA"])).sum() + (dW * _t(x["cW"])).sum(), ins)
    _close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("nu", [1, 2])
def test_symcon_op_grad_of_grad_matches_jax(nu):
    """Grad-of-grad through the whole wrapper (padding, species gather):
    the gradient with respect to (A, weights) of <c, d<B, G>/dA>."""
    jspec, tspec, x = _symcon_case(nu, seed=20 + nu)
    rng = np.random.default_rng(nu)
    N = 21  # ragged against block_n = 8: padded atoms
    A = rng.normal(size=(N, K_SC, tspec.in_spec.dim)).astype(np.float32)
    G = rng.normal(size=(N, K_SC, tspec.out_spec.dim)).astype(np.float32)
    c = rng.normal(size=A.shape).astype(np.float32)
    species = rng.integers(0, N_SPECIES, N).astype(np.int32)
    weights = {f"w_L{L}_nu{n}": rng.normal(size=shp).astype(np.float32)
               for (L, n), shp in jspec.weight_shapes(N_SPECIES, K_SC).items()}

    def jscalar(a, w):
        def inner(aa):
            return jnp.sum(symcon_pallas(aa, jnp.asarray(species), w, jspec,
                                         block_n=8, interpret=True) * G)
        return jnp.sum(jax.grad(inner)(a) * c)

    want_a, want_w = jax.grad(jscalar, argnums=(0, 1))(A, weights)
    a = _t(A, grad=True)
    tw = {k: _t(v, grad=True) for k, v in weights.items()}
    B = symcon_cuda(a, _t(species).long(), tw, tspec, block_n=8)
    (da,) = torch.autograd.grad((B * _t(G)).sum(), a, create_graph=True)
    got = torch.autograd.grad((da * _t(c)).sum(), [a, *tw.values()])
    _close(got, [want_a] + [want_w[k] for k in tw], **GRAD_TOL)


@pytest.mark.parametrize("nu", [1, 2, 3])
def test_symcon_dbl_plain_matches_the_double_vjp_of_symcon_plain(nu):
    """The second order's explicit product rule (``_SymconBwdOp``'s CPU
    path, and the plain version the card's ``symcon_dbl`` is held to)
    against autograd's double VJP of the JAX-parity twin ``symcon_plain``,
    with cotangents (cA, cW) of (dA, dW)."""
    _, tspec, x = _symcon_case(nu, seed=30 + nu)
    a, w, g = (_t(x[n], grad=True) for n in ("A", "W", "G"))
    dA, dW = torch.autograd.grad(symcon_plain(a, w, tspec), (a, w), g, create_graph=True)
    want = torch.autograd.grad((dA, dW), (a, w, g), (_t(x["cA"]), _t(x["cW"])))
    got = symcon_dbl_plain(*(_t(x[n]) for n in ("A", "W", "G", "cA", "cW")), tspec)
    _close(got, [t.numpy() for t in want], **TWIN_TOL)


def test_symcon_refuses_a_third_order():
    _, tspec, x = _symcon_case(2, seed=3)
    ins = [_t(x[n], grad=True) for n in ("A", "W", "G")]
    dA, _ = _SymconBwdOp.apply(*ins, tspec)
    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.autograd.grad(dA.square().sum(), ins, create_graph=True)


# ---------------------------------------------------------------------------
# interaction op
# ---------------------------------------------------------------------------

AVG = 4.0
INT_CASES = {
    # random receivers, masked edges, fully masked padding tiles
    "random": dict(E=96, n_atoms=21, receivers=None),
    # atoms with no edges + a hub atom spanning three tiles with one base
    "empty_and_hub": dict(E=64, n_atoms=16, receivers="hub"),
}


def _int_case(name, seed, k=4):
    c = INT_CASES[name]
    jspec = JISpec(JTPSpec(jsh(2), jlspec(0, 1), jlspec(0, 1, 2)), AVG, 8)
    tspec = TISpec(TTPSpec(tsh(2), tlspec(0, 1), tlspec(0, 1, 2)), AVG, 8)
    rng = np.random.default_rng(seed)
    E, n = c["E"], c["n_atoms"]
    tp = tspec.tp
    x = {
        "Y": rng.normal(size=(E, tp.y_spec.dim)), "h": rng.normal(size=(n, k, tp.h_spec.dim)),
        "R": rng.normal(size=(E, tp.n_paths, k)), "g": rng.normal(size=(n, k, tp.out_spec.dim)),
    }
    x = {key: v.astype(np.float32) for key, v in x.items()}
    for key in ("Y", "h", "R"):
        x["c" + key] = rng.normal(size=x[key].shape).astype(np.float32)
    x["senders"] = rng.integers(0, n, E).astype(np.int32)
    if c["receivers"] == "hub":
        x["receivers"] = np.concatenate([np.full(48, 3), np.full(16, 11)]).astype(np.int32)
        x["edge_mask"] = np.ones(E, bool)
    else:
        x["receivers"] = rng.integers(0, n, E).astype(np.int32)
        x["edge_mask"] = rng.random(E) < 0.9
    b = block_edges(x["receivers"], x["edge_mask"], n, block_n=8, block_e=16)
    if c["receivers"] == "hub":
        assert (b.tile_base == 0).sum() == 3  # the hub spills over three tiles
    assert not b.valid[-b.epb:].any()          # a fully masked padding tile
    x.update(perm=b.perm, valid=b.valid, local=b.local_rcv, base=b.tile_base)
    return jspec, tspec, x


def _int_ints(x):
    return [x[n] for n in ("senders", "receivers", "edge_mask", "perm", "valid",
                           "local", "base")]


def _blocked_ints(x):
    """``_InteractionBwd``'s integer operands: senders and the blocking."""
    s, perm, valid, local, base = (_t(x[n]) for n in ("senders", "perm", "valid", "local",
                                                      "base"))
    return [s, perm, valid, local.to(torch.int32), base]


@pytest.mark.parametrize("route", ["blocked", "unblocked"])
@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_blocked_bwd_op_second_order_matches_jax(name, route):
    """d/d(g, Y, h, R) of <c, (dY, dh, dR)> for the backward op, its second
    order the plain versions of the second-order kernels: over the case's
    blocking against the JAX ``_blocked_bwd_op``, and over the identity
    blocking (``tp_cuda``'s, per-edge g and h) against the JAX ``_tp_bwd_op``."""
    jspec, tspec, x = _int_case(name, seed=len(name) + len(route))
    if route == "unblocked":
        s, r = x["senders"], x["receivers"]
        x = dict(x, g=x["g"][r], h=x["h"][s], ch=x["ch"][s])
        ints = [torch.arange(len(s)), *tp_ops.identity_blocking(len(s), "cpu").values()]
        tspec = TISpec(tspec.tp, 1.0, block_n=tp_ops.IDENTITY_TILE)

        def jbwd(g, Y, h, R):
            return _tp_bwd_op(jspec.tp, tp_ops.IDENTITY_TILE, True, "fp32", g, Y, h, R)
    else:
        ints = _blocked_ints(x)

        def jbwd(g, Y, h, R):
            return _blocked_bwd_op(jspec, True, g, Y, h, R,
                                   *(jnp.asarray(a) for a in _int_ints(x)))

    def jscalar(g, Y, h, R):
        dY, dh, dR = jbwd(g, Y, h, R)
        return sum(jnp.sum(d * x[c]) for d, c in ((dY, "cY"), (dh, "ch"), (dR, "cR")))

    want = jax.grad(jscalar, argnums=(0, 1, 2, 3))(x["g"], x["Y"], x["h"], x["R"])
    ins = [_t(x[n], grad=True) for n in ("g", "Y", "h", "R")]
    outs = tp_ops._InteractionBwd.apply(*ins, *ints, tspec)
    scalar = sum((d * _t(x[c])).sum() for d, c in zip(outs, ("cY", "ch", "cR")))
    _close(torch.autograd.grad(scalar, ins), want, **GRAD_TOL)


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_blocked_second_order_matches_the_twin(name):
    """The plain versions of the second-order kernels (``_InteractionBwd``'s
    second order on the CPU) against autograd's double VJP of
    ``interaction_fused`` on the same cotangents, in one pass: masked edges,
    a fully masked padding tile, atoms without edges and a hub over three
    tiles."""
    _, tspec, x = _int_case(name, seed=40 + len(name))
    g, Y, h, R = (_t(x[n], grad=True) for n in ("g", "Y", "h", "R"))
    cot = [_t(x[n]) for n in ("cY", "ch", "cR")]
    s, r, m, perm, valid, local, base = (_t(a) for a in _int_ints(x))
    got = tp_ops._blocked_second_order(tspec, g, Y, h, R, s, perm, valid,
                                       local.to(torch.int32), base, *cot)
    first = torch.autograd.grad(interaction_fused(Y, h, R, s, r, m, spec=tspec), (Y, h, R),
                                g, create_graph=True)
    want = torch.autograd.grad(first, (g, Y, h, R), cot)
    _close(got, [w.numpy() for w in want], **TWIN_TOL)


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_interaction_op_grad_of_grad_matches_jax(name):
    """Grad-of-grad through the registered op: the gradient with respect to
    (Y, h, R) of <c, d<A, g>/d(Y, h, R)>."""
    jspec, tspec, x = _int_case(name, seed=7)
    jb = {"perm": x["perm"], "valid": x["valid"], "local": x["local"], "base": x["base"]}
    s, r, m = (jnp.asarray(x[n]) for n in ("senders", "receivers", "edge_mask"))

    def jscalar(Y, h, R):
        def inner(y, hh, rr):
            return jnp.sum(interaction_pallas_op(y, hh, rr, s, r, m, spec=jspec,
                                                 blocking=jb, interpret=True) * x["g"])
        grads = jax.grad(inner, argnums=(0, 1, 2))(Y, h, R)
        return sum(jnp.sum(d * x[c]) for d, c in zip(grads, ("cY", "ch", "cR")))

    want = jax.grad(jscalar, argnums=(0, 1, 2))(x["Y"], x["h"], x["R"])
    ins = [_t(x[n], grad=True) for n in ("Y", "h", "R")]
    tb = {k: _t(v) for k, v in jb.items()}
    A = tp_ops.interaction_cuda_op(*ins, _t(x["senders"]), _t(x["receivers"]),
                                   _t(x["edge_mask"]), spec=tspec, blocking=tb)
    first = torch.autograd.grad((A * _t(x["g"])).sum(), ins, create_graph=True)
    scalar = sum((d * _t(x[c])).sum() for d, c in zip(first, ("cY", "ch", "cR")))
    _close(torch.autograd.grad(scalar, ins), want, **GRAD_TOL)


def test_interaction_twins_match_jax():
    """``tp_ref``/``tp_fused`` on gathered operands and ``interaction_ref``/
    ``interaction_fused`` on the unblocked arrays, against the JAX twins."""
    jspec, tspec, x = _int_case("random", seed=5)
    h_send = x["h"][x["senders"]]
    want = jtp_ref(x["Y"], h_send, x["R"], jspec.tp)
    for fn in (tp_ref, tp_fused):
        got = fn(_t(x["Y"]), _t(h_send), _t(x["R"]), tspec.tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TWIN_TOL)
    np.testing.assert_allclose(np.asarray(jtp_fused(x["Y"], h_send, x["R"], jspec.tp)),
                               np.asarray(want), **TWIN_TOL)
    ints = [x[n] for n in ("senders", "receivers", "edge_mask")]
    want = jint_fused(x["Y"], x["h"], x["R"], *map(jnp.asarray, ints), spec=jspec)
    np.testing.assert_allclose(
        np.asarray(jint_ref(x["Y"], x["h"], x["R"], *map(jnp.asarray, ints), spec=jspec)),
        np.asarray(want), **TWIN_TOL)
    for fn in (interaction_ref, interaction_fused):
        got = fn(_t(x["Y"]), _t(x["h"]), _t(x["R"]), *map(_t, ints), spec=tspec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TWIN_TOL)


def test_interaction_refuses_a_third_order():
    _, tspec, x = _int_case("random", seed=9)
    ins = [_t(x[n], grad=True) for n in ("g", "Y", "h", "R")]
    dY, _, _ = tp_ops._InteractionBwd.apply(*ins, *_blocked_ints(x), tspec)
    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.autograd.grad(dY.square().sum(), ins, create_graph=True)


# ---------------------------------------------------------------------------
# the weighted loss
# ---------------------------------------------------------------------------

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
JCFG = JConfig(**WIDTHS, impl="pallas", interaction_impl="pallas",
               interaction_bwd_impl="pallas", precision="fp32")
TCFG = TConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
SHAPE = dict(max_nodes=48, max_edges=1152, max_graphs=4, block_n=8, block_e=32)


@functools.lru_cache(maxsize=None)
def _batch():
    ds = SyntheticCFMDataset(24, seed=5, max_atoms=20)
    mols, n = [], 0
    for i in range(len(ds)):
        m = ds.get(i)
        if m.n_edges and n + m.n_atoms <= 40 and len(mols) < 3:
            mols.append(m)
            n += m.n_atoms
    jb = jcollate(mols, JBinShape(**SHAPE), strict=True, with_blocking=True)
    tb = collate_bin(mols, BinShape(**SHAPE), strict=True, with_blocking=True)
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    return tb


def test_weighted_loss_and_param_grads_match_jax():
    batch = _batch()
    G = SHAPE["max_graphs"]
    jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(7), JCFG))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, JCFG, b, G), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jp)
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tloss(params, TCFG, tb, G)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for key in ("loss", "e_rmse", "f_rmse"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]),
                                   rtol=2e-5)
    want = _flatten(jg)
    assert want.keys() == leaves.keys()
    for (key, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[key], **GRAD_TOL, err_msg=key)
    assert param_count(params) == sum(v.size for v in want.values())
    assert float(loss.detach()) > 0 and max(float(np.abs(w).max()) for w in want.values()) > 0


def test_energy_forces_graph_equals_the_serving_path():
    """The training path's energies and forces are the serving path's
    (within the reference's 2e-5), but keep their graph: the forces
    differentiate again with respect to the parameters."""
    batch = _batch()
    G = SHAPE["max_graphs"]
    params = params_from_jax(jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(8), JCFG)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    e0, f0 = mace_energy_forces(params, TCFG, tb, G)
    embed = params["embed"].requires_grad_(True)
    e1, f1 = energy_forces_graph(params, TCFG, tb, G)
    # autograd may order the sums differently when it builds a graph
    np.testing.assert_allclose(e0.numpy(), e1.detach().numpy(), **TWIN_TOL)
    np.testing.assert_allclose(f0.numpy(), f1.detach().numpy(), **TWIN_TOL)
    assert f1.requires_grad and not f0.requires_grad
    (d,) = torch.autograd.grad(f1.square().sum(), embed)
    assert torch.isfinite(d).all() and float(d.abs().max()) > 0
