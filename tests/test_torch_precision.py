"""Port parity, the kernel variants: the bf16 and fp8 operand rounding, the
TP-only op and the unblocked interaction (the identity-blocked kernels),
the fused interaction backward, and ``MaceConfig``/``TrainerConfig``
precision, against the JAX package on the same numpy inputs.  The port runs
its plain versions (CPU tensors), the JAX package its Pallas kernels in
interpret mode.

Tolerances:
- ``round_to`` bit for bit (NaN beyond +-464 and for the infinities in fp8);
- fp32 impls the reference's own: 2e-5 for values (tests/test_kernels.py),
  2e-4 for gradients and grad-of-grad (tests/test_backward.py);
- a variant against the same JAX variant: the symmetric contraction and
  every backward round only loaded operands and must agree within 2e-5 of
  the output's largest magnitude; the interaction forward rounds each
  message, an fp32 sum taken in another order, so a message may land one
  bf16 / fp8 unit apart: L2 norm-relative 1e-3 (bf16) and 1e-2 (fp8);
- a variant against the fp32 oracle, and model-level results:
  ``PRECISION_TOL`` (tests/test_precision.py, L2 norm-relative), and not
  bitwise equal to fp32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channelwise_tp import TPSpec as JTPSpec
from repro.core.interaction import InteractionSpec as JSpec
from repro.core.irreps import lspec as jlspec
from repro.core.irreps import sh_spec as jsh
from repro.core.mace import MaceConfig as JConfig
from repro.core.mace import init_mace as jinit
from repro.core.mace import mace_energy_forces as jforces
from repro.core.symmetric_contraction import SymConSpec as JSymConSpec
from repro.core.symmetric_contraction import build_symcon_tables as jsymcon_tables
from repro.data.collate import BinShape as JBinShape
from repro.data.collate import collate_bin as jcollate
from repro.data.molecules import SyntheticCFMDataset as JDataset
from repro.kernels.channelwise_tp.ops import interaction_pallas_op, tp_pallas
from repro.kernels.precision import round_to as jround_to
from repro.kernels.symmetric_contraction.kernel import (
    symcon_bwd_pallas_raw,
    symcon_pallas_raw,
)
from repro.kernels.symmetric_contraction.ops import symcon_pallas
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.bridge import JAX_BWD_IMPL_NAMES, params_from_jax
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.interaction import InteractionSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.core.mace import MaceConfig
from repro_torch.core.mace import mace_energy_forces as tforces
from repro_torch.core.symmetric_contraction import SymConSpec
from repro_torch.data.blocking import block_edges
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.kernels import registry
from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op, tp_cuda
from repro_torch.kernels.precision import PRECISIONS, check_precision, round_to
from repro_torch.kernels.symmetric_contraction import kernel as sck
from repro_torch.train.train_loop import Trainer, TrainerConfig

PRECISION_TOL = {"fp32": 2e-4, "bf16": 5e-2, "fp8": 4e-1}
TP_FWD_L2 = {"bf16": 1e-3, "fp8": 1e-2}
VARIANTS = ["bf16", "fp8"]
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _l2_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / denom) if denom else float(np.linalg.norm(got))


def _close_to_scale(got, want, tol=2e-5):
    """Every element within ``tol`` of the reference's largest magnitude."""
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), (np.abs(g - w).max(),
                                                              np.abs(w).max())


def _within_tol_and_live(got, fp32, precision):
    for g, w in zip(got, fp32):
        assert _l2_rel(g, w) <= PRECISION_TOL[precision], _l2_rel(g, w)
    assert max(np.abs(np.asarray(g) - np.asarray(w)).max() for g, w in zip(got, fp32)) > 0, (
        "reduced precision returned bitwise fp32")


def _allclose(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------

# zeros; fp8's largest value 448 and its NaN threshold above 464; the
# infinities and NaNs (their payloads and signs); ties to even of both
# types; subnormals of e4m3; bf16's overflow to infinity
EDGE_BITS = [0x7fc00000, 0xffc00000, 0x7f800001, 0xff812345, 0x7ff00000]
EDGES = [0.0, -0.0, 448.0, 449.0, 464.0, -464.0, 465.0, -465.0, 480.0, 1000.0,
         float("inf"), float("-inf"), 1.0625, 1.1875, -1.0625, 1 + 2 ** -8,
         1 + 3 * 2 ** -8, 2 ** -10, 1.5 * 2 ** -9, 1.25 * 2 ** -9, 2 ** -7 * 1.0625,
         3.3e38, -3.4e38, 2 ** -130]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_round_to_matches_jax_bit_for_bit(precision):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.asarray(EDGE_BITS, np.uint32).view(np.float32), np.asarray(EDGES, np.float32),
        (rng.standard_normal(100_000) * np.exp(rng.uniform(-14, 8, 100_000))).astype(np.float32),
    ])
    got = round_to(torch.from_numpy(x), precision).numpy().view(np.uint32)
    want = np.asarray(jround_to(jnp.asarray(x), precision)).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    if precision == "fp8":
        y = round_to(torch.tensor([464.0, 465.0, -1000.0, float("inf")]), "fp8")
        assert float(y[0]) == 448.0 and torch.isnan(y[1:]).all()


def test_round_to_contract():
    """Port of tests/test_precision.py::test_round_to_contract."""
    x = torch.linspace(-3.0, 3.0, 97) * 1.7
    assert round_to(x, "fp32") is x
    for prec, eps in (("bf16", 2 ** -8), ("fp8", 2 ** -2)):
        y = round_to(x, prec)
        assert y.dtype == torch.float32
        rel = (y - x).abs() / x.abs().clamp(min=1e-9)
        assert 0.0 < float(rel.max()) <= eps
    with pytest.raises(ValueError):
        check_precision("fp16")
    assert [check_precision(p) for p in PRECISIONS] == list(PRECISIONS)


# ---------------------------------------------------------------------------
# the symmetric contraction
# ---------------------------------------------------------------------------


def _symcon_case(seed=0, N=17, k=4):
    """17 atoms: a ragged last tile of the reference's 32-atom blocks."""
    jspec = JSymConSpec(jlspec(0, 1, 2), jlspec(0, 1), 2)
    spec = SymConSpec(lspec(0, 1, 2), lspec(0, 1), 2)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, k, spec.in_spec.dim)).astype(np.float32)
    species = rng.integers(0, 3, N).astype(np.int32)
    W = {f"w_L{L}_nu{nu}": (rng.normal(size=shp) / np.sqrt(shp[-1])).astype(np.float32)
         for (L, nu), shp in spec.weight_shapes(3, k).items()}
    G = rng.normal(size=(N, k, spec.out_spec.dim)).astype(np.float32)
    return jspec, spec, A, species, W, G


@pytest.mark.parametrize("precision", PRECISIONS)
def test_symcon_kernel_layout_variants_match_jax_raw_kernels(precision):
    """The plain versions the wrappers take on the CPU against the raw Pallas
    kernels at the same precision."""
    jspec, spec, *_ = _symcon_case()
    rng = np.random.default_rng(1)
    N, k, P = 32, 4, sck.p_total_of(spec)
    A_t, W_t, G_t = (rng.normal(size=(N, d, k)).astype(np.float32)
                     for d in (spec.in_spec.dim, P, spec.out_spec.dim))
    t = jsymcon_tables(jspec)
    want = [symcon_pallas_raw(A_t, W_t, jspec, t, interpret=True, precision=precision),
            *symcon_bwd_pallas_raw(A_t, W_t, G_t, jspec, t, interpret=True,
                                   precision=precision)]
    got = [sck.symcon_fwd(_t(A_t), _t(W_t), spec, precision),
           *sck.symcon_bwd(_t(A_t), _t(W_t), _t(G_t), spec, precision)]
    _close_to_scale([g.numpy() for g in got], want)
    if precision != "fp32":
        fp32 = [sck.symcon_plain(_t(A_t), _t(W_t), spec),
                *sck.symcon_bwd_plain(_t(A_t), _t(W_t), _t(G_t), spec)]
        _within_tol_and_live([g.numpy() for g in got], [f.numpy() for f in fp32], precision)


@pytest.mark.parametrize("precision", VARIANTS)
def test_symcon_precision_parity(precision):
    """Port of tests/test_precision.py::test_symcon_precision_parity: the
    variant's value and gradients of sum(B^2) against the same JAX variant
    and against the fp32 ``ref`` oracle."""
    jspec, spec, A, species, W, _ = _symcon_case()

    def jloss(a, w):
        return jnp.sum(symcon_pallas(a, jnp.asarray(species), w, jspec, interpret=True,
                                     precision=precision) ** 2)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1))(A, W)
    names = sorted(W)

    def port(impl):
        a, w = _t(A, grad=True), {n: _t(W[n], grad=True) for n in names}
        B = registry.resolve("symcon", impl, spec)(a, _t(species).long(), w)
        loss = (B ** 2).sum()
        return [loss.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(
            loss, [a, *w.values()]))]

    got = port(f"cuda_{precision}")
    want = [np.asarray(jv), np.asarray(jg[0]), *(np.asarray(jg[1][n]) for n in names)]
    _close_to_scale(got, want)
    _within_tol_and_live(got, port("ref"), precision)


# ---------------------------------------------------------------------------
# the TP-only op and the interaction op
# ---------------------------------------------------------------------------

AVG = 4.0


def _specs(precision="fp32", bwd="cuda", block_n=8):
    j = JSpec(JTPSpec(jsh(2), jlspec(0, 1), jlspec(0, 1, 2)), AVG, block_n,
              {v: k for k, v in JAX_BWD_IMPL_NAMES.items()}[bwd], precision)
    t = InteractionSpec(TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2)), AVG, block_n,
                        bwd, precision)
    return j, t


def _tp_case(seed, E=48, k=4):
    _, spec = _specs()
    rng = np.random.default_rng(seed)
    tp = spec.tp
    Y, h, R, g = (rng.normal(size=s).astype(np.float32) for s in (
        (E, tp.y_spec.dim), (E, k, tp.h_spec.dim), (E, tp.n_paths, k),
        (E, k, tp.out_spec.dim)))
    c = [rng.normal(size=a.shape).astype(np.float32) for a in (Y, h, R)]
    return Y, h, R, g, c


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tp_cuda_matches_jax_tp_pallas(precision):
    """``tp_cuda`` against ``tp_pallas`` at one precision on 200 edges (two
    identity tiles, the second padded): forward, and the VJP with a fixed
    cotangent."""
    jspec, spec = _specs()
    Y, h, R, g, _ = _tp_case(1, E=200)
    want, vjp = jax.vjp(lambda y, hh, r: tp_pallas(y, hh, r, jspec.tp, interpret=True,
                                                   precision=precision), Y, h, R)
    ins = [_t(a, grad=True) for a in (Y, h, R)]
    got = tp_cuda(*ins, spec.tp, precision=precision)
    grads = torch.autograd.grad(got, ins, _t(g))
    if precision == "fp32":
        _allclose([got.detach()], [want], **VALUE_TOL)
    else:
        err = _l2_rel(got.detach(), want)
        print(f"tp_cuda {precision}: forward L2-relative to tp_pallas {err:.3e}")
        assert err <= TP_FWD_L2[precision], err
    _close_to_scale([x.numpy() for x in grads], vjp(g))


@pytest.mark.parametrize("precision", VARIANTS)
def test_tp_precision_parity(precision):
    """Port of tests/test_precision.py::test_tp_precision_parity: value and
    gradients of sum(msgs^2) of ``channelwise_tp/cuda_<p>`` against the fp32
    ``ref`` oracle."""
    _, spec = _specs()
    Y, h, R, _, _ = _tp_case(2)

    def port(impl):
        ins = [_t(a, grad=True) for a in (Y, h, R)]
        loss = (registry.resolve("channelwise_tp", impl, spec.tp)(*ins) ** 2).sum()
        return [loss.detach().numpy(), *(x.numpy() for x in torch.autograd.grad(loss, ins))]

    _within_tol_and_live(port(f"cuda_{precision}"), port("ref"), precision)


def test_tp_cuda_on_no_edges():
    """``tp_cuda`` on 0 edges: an empty [0, k, d_out], and empty first and
    second derivatives of the inputs' shapes."""
    _, spec = _specs()
    Y, h, R, g, c = _tp_case(4, E=0)
    ins = [_t(a, grad=True) for a in (Y, h, R)]
    out = tp_cuda(*ins, spec.tp)
    assert out.shape == g.shape == (0, 4, spec.tp.out_spec.dim)
    first = torch.autograd.grad((out * _t(g)).sum(), ins, create_graph=True)
    second = torch.autograd.grad(sum((f * _t(ci)).sum() for f, ci in zip(first, c)), ins)
    assert [t.shape for t in (*first, *second)] == [t.shape for t in ins] * 2


def test_tp_cuda_grad_of_grad_matches_jax():
    """The gradient with respect to (Y, h, R) of <c, d<msgs, g>/d(Y, h, R)>:
    the JAX ``_tp_bwd_op`` rule against the second-order kernels' plain
    versions under the identity blocking."""
    jspec, spec = _specs()
    Y, h, R, g, c = _tp_case(3, E=150)

    def jscalar(y, hh, r):
        first = jax.grad(lambda a, b, d: jnp.sum(
            tp_pallas(a, b, d, jspec.tp, interpret=True) * g), argnums=(0, 1, 2))(y, hh, r)
        return sum(jnp.sum(f * ci) for f, ci in zip(first, c))

    want = jax.grad(jscalar, argnums=(0, 1, 2))(Y, h, R)
    ins = [_t(a, grad=True) for a in (Y, h, R)]
    first = torch.autograd.grad((tp_cuda(*ins, spec.tp) * _t(g)).sum(), ins, create_graph=True)
    got = torch.autograd.grad(sum((f * _t(ci)).sum() for f, ci in zip(first, c)), ins)
    _allclose([x.numpy() for x in got], want, **GRAD_TOL)


CASES = {
    # padded atoms (21: a ragged tile of 8 rows), about 10% masked edges
    "masked_padded": dict(E=64, n_atoms=21, keep=0.9, hub=False),
    # every edge masked: exact zeros out and back
    "empty_bin": dict(E=32, n_atoms=9, keep=0.0, hub=False),
    # a hub receiver spilling over three tiles of one base
    "hub_spill": dict(E=64, n_atoms=16, keep=1.0, hub=True),
}


def _int_case(name, seed=0, k=4):
    c = CASES[name]
    _, spec = _specs()
    tp = spec.tp
    rng = np.random.default_rng(seed)
    E, n = c["E"], c["n_atoms"]
    x = dict(Y=rng.normal(size=(E, tp.y_spec.dim)), h=rng.normal(size=(n, k, tp.h_spec.dim)),
             R=rng.normal(size=(E, tp.n_paths, k)), g=rng.normal(size=(n, k, tp.out_spec.dim)))
    x = {key: v.astype(np.float32) for key, v in x.items()}
    x["c"] = [rng.normal(size=x[key].shape).astype(np.float32) for key in ("Y", "h", "R")]
    x["senders"] = rng.integers(0, n, E).astype(np.int32)
    if c["hub"]:
        x["receivers"] = np.concatenate([np.full(48, 3), np.full(16, 11)]).astype(np.int32)
    else:
        x["receivers"] = rng.integers(0, n, E).astype(np.int32)
    x["edge_mask"] = rng.random(E) < c["keep"]
    b = block_edges(x["receivers"], x["edge_mask"], n, block_n=8, block_e=16)
    if c["hub"]:
        assert (b.tile_base == 0).sum() == 3
    x["blocking"] = {"perm": b.perm, "valid": b.valid, "local": b.local_rcv,
                     "base": b.tile_base}
    return x


def _jax_op(x, jspec, blocked):
    blk = {k: jnp.asarray(v) for k, v in x["blocking"].items()} if blocked else None
    ints = [jnp.asarray(x[n]) for n in ("senders", "receivers", "edge_mask")]
    return lambda y, hh, r: interaction_pallas_op(y, hh, r, *ints, spec=jspec,
                                                  blocking=blk, interpret=True)


def _port_op(x, spec, blocked, impl=None):
    blk = {k: _t(v) for k, v in x["blocking"].items()} if blocked else None
    ints = [_t(x[n]) for n in ("senders", "receivers", "edge_mask")]
    fn = (functools.partial(interaction_cuda_op, spec=spec) if impl is None
          else registry.resolve("interaction", impl, spec))
    return lambda y, hh, r: fn(y, hh, r, *ints, blocking=blk)


def _port_vjp(op, x):
    ins = [_t(x[n], grad=True) for n in ("Y", "h", "R")]
    A = op(*ins)
    return A.detach().numpy(), [g.numpy() for g in torch.autograd.grad(A, ins, _t(x["g"]))]


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "unblocked"])
@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_interaction_variant_matches_jax_variant(name, precision, blocked):
    """The interaction op at bf16 / fp8, blocked and unblocked, against
    ``interaction_pallas_op`` at the same precision: the forward within the
    message-rounding bound, the VJP with a fixed cotangent within 2e-5 of
    its largest magnitude; an empty bin gives exact zeros both ways."""
    x = _int_case(name, seed=len(name))
    jspec, spec = _specs(precision)
    want, vjp = jax.vjp(_jax_op(x, jspec, blocked), x["Y"], x["h"], x["R"])
    got, grads = _port_vjp(_port_op(x, spec, blocked), x)
    if name == "empty_bin":
        assert not np.any(got) and not any(np.any(g) for g in grads)
        return
    err = _l2_rel(got, want)
    print(f"interaction {name} {precision} blocked={blocked}: forward L2-relative "
          f"to interaction_pallas_op {err:.3e}")
    assert err <= TP_FWD_L2[precision], err
    _close_to_scale(grads, vjp(jnp.asarray(x["g"])))


def _sq_grads(op, x):
    ins = [_t(x[n], grad=True) for n in ("Y", "h", "R")]
    return [g.numpy() for g in torch.autograd.grad((op(*ins) ** 2).sum(), ins)]


@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("name", ["masked_padded", "hub_spill"])
def test_interaction_precision_parity_against_the_fp32_oracle(name, precision):
    """Ports of tests/test_precision.py::test_interaction_precision_parity_
    masked_padded and ``..._hub_spill``: gradients of sum(A^2) of the
    registered ``cuda_<p>`` impl against the fp32 ``ref`` oracle."""
    x = _int_case(name, seed=7)
    _, spec = _specs()
    got = _sq_grads(_port_op(x, spec, True, f"cuda_{precision}"), x)
    _within_tol_and_live(got, _sq_grads(_port_op(x, spec, False, "ref"), x), precision)


@pytest.mark.parametrize("precision", VARIANTS)
def test_interaction_precision_empty_bin_exact_zeros(precision):
    """Port of tests/test_precision.py::test_interaction_precision_empty_bin_
    exact_zeros: an all-masked bin's cotangents are exact zeros."""
    x = _int_case("empty_bin", seed=3)
    _, spec = _specs()
    for g in _sq_grads(_port_op(x, spec, True, f"cuda_{precision}"), x):
        np.testing.assert_array_equal(g, np.zeros_like(g))


@pytest.mark.parametrize("name", ["masked_padded", "hub_spill"])
def test_unblocked_interaction_matches_jax_forward_backward_and_second_order(name):
    """fp32: the unblocked path (identity-blocked kernels + receiver sum)
    against ``interaction_pallas_op(blocking=None)``: forward, the VJP, and
    the gradient with respect to (Y, h, R) of <c, d<A, g>/d(Y, h, R)>."""
    x = _int_case(name, seed=11)
    jspec, spec = _specs()
    jop, op = _jax_op(x, jspec, False), _port_op(x, spec, False)
    want, vjp = jax.vjp(jop, x["Y"], x["h"], x["R"])
    got, grads = _port_vjp(op, x)
    _allclose([got], [want], **VALUE_TOL)
    _allclose(grads, vjp(jnp.asarray(x["g"])), **GRAD_TOL)
    _second_order_matches(jop, op, x)


def _second_order_matches(jop, op, x):
    def jscalar(y, hh, r):
        first = jax.grad(lambda a, b, d: jnp.sum(jop(a, b, d) * x["g"]),
                         argnums=(0, 1, 2))(y, hh, r)
        return sum(jnp.sum(f * c) for f, c in zip(first, x["c"]))

    want = jax.grad(jscalar, argnums=(0, 1, 2))(x["Y"], x["h"], x["R"])
    ins = [_t(x[n], grad=True) for n in ("Y", "h", "R")]
    first = torch.autograd.grad((op(*ins) * _t(x["g"])).sum(), ins, create_graph=True)
    got = torch.autograd.grad(sum((f * _t(c)).sum() for f, c in zip(first, x["c"])), ins)
    _allclose([g.numpy() for g in got], want, **GRAD_TOL)


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "unblocked"])
def test_fused_backward_matches_jax_xla_to_second_order(blocked):
    """``bwd_impl="fused"`` against the JAX ``"xla"`` knob: the VJP and the
    grad-of-grad (autograd through ``interaction_fused`` on both sides)."""
    x = _int_case("hub_spill", seed=13)
    jspec, spec = _specs(bwd="fused")
    jop, op = _jax_op(x, jspec, blocked), _port_op(x, spec, blocked)
    _, vjp = jax.vjp(jop, x["Y"], x["h"], x["R"])
    _allclose(_port_vjp(op, x)[1], vjp(jnp.asarray(x["g"])), **GRAD_TOL)
    _second_order_matches(jop, op, x)


def test_fused_backward_launches_no_backward_kernel_and_differentiates_again():
    """The fused backward is autograd's, so it builds a graph where the
    kernel backward's twin refuses a third order."""
    x = _int_case("masked_padded", seed=5)
    _, spec = _specs(bwd="fused")
    ins = [_t(x[n], grad=True) for n in ("Y", "h", "R")]
    first = torch.autograd.grad((_port_op(x, spec, True)(*ins) ** 2).sum(), ins,
                                create_graph=True)
    second = torch.autograd.grad(sum((f ** 2).sum() for f in first), ins, create_graph=True)
    assert all(s.requires_grad for s in second)
    with pytest.raises(ValueError):
        InteractionSpec(spec.tp, AVG, bwd_impl="xla")
    with pytest.raises(ValueError):
        InteractionSpec(spec.tp, AVG, precision="fp16")


# ---------------------------------------------------------------------------
# the model: config, energies and forces, a training trajectory
# ---------------------------------------------------------------------------

TINY_KW = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
               a_ls=(0, 1, 2), correlation=2, n_interactions=2,
               avg_num_neighbors=8.0)


def test_mace_config_precision_resolution():
    """Port of tests/test_precision.py::test_mace_config_precision_resolution,
    under the port's names."""
    cfg = MaceConfig(**TINY_KW, impl="cuda", interaction_impl="cuda", precision="bf16")
    assert cfg.symcon_impl_name == "cuda_bf16"
    assert cfg.interaction_impl_name == "cuda_bf16"
    assert cfg.interaction_spec_at(0).precision == "bf16"
    cfg2 = dataclasses.replace(cfg, impl="cuda_bf16")
    assert cfg2.symcon_impl_name == "cuda_bf16"
    cfg3 = MaceConfig(**TINY_KW, impl="fused", interaction_impl="fused")
    assert cfg3.symcon_impl_name == "fused" and cfg3.interaction_impl_name == "fused"
    assert cfg3.interaction_spec_at(0).precision == "fp32"
    assert cfg3.interaction_spec_at(1).bwd_impl == "cuda"
    # "auto" is left for the build paths to resolve, as in the reference
    cfg4 = MaceConfig(**TINY_KW, impl="auto", precision="bf16")
    assert cfg4.symcon_impl_name == JConfig(**TINY_KW, impl="auto",
                                            precision="bf16").symcon_impl_name == "auto"
    cfg5 = MaceConfig(**TINY_KW, impl="fused", precision="bf16")
    with pytest.raises(ValueError, match="no 'bf16' variant"):
        cfg5.symcon_impl_name
    with pytest.raises(ValueError):
        MaceConfig(**TINY_KW, precision="fp16")
    # the same names as the reference's resolution, mapped
    jcfg = JConfig(**TINY_KW, impl="pallas", interaction_impl="pallas", precision="fp8")
    tcfg = MaceConfig(**TINY_KW, precision="fp8")
    assert (tcfg.symcon_impl_name, tcfg.interaction_impl_name) == (
        jcfg.symcon_impl_name.replace("pallas", "cuda"),
        jcfg.interaction_impl_name.replace("pallas", "cuda"))


SHAPE = dict(max_nodes=48, max_edges=1152, max_graphs=4, block_n=8, block_e=32)


@functools.lru_cache(maxsize=None)
def _model_case():
    ds = JDataset(24, seed=3, max_atoms=20)
    mols, n = [], 0
    for i in range(len(ds)):
        m = ds.get(i)
        if m.n_edges and n + m.n_atoms <= 40 and len(mols) < 3:
            mols.append(m)
            n += m.n_atoms
    batch = collate_bin(mols, BinShape(**SHAPE), strict=True, with_blocking=True)
    jbatch = jcollate(mols, JBinShape(**SHAPE), strict=True, with_blocking=True)
    for key in batch:
        np.testing.assert_array_equal(batch[key], jbatch[key])
    jcfg = JConfig(**TINY_KW, interaction_block_n=8, impl="pallas", interaction_impl="pallas")
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(4), jcfg))
    return batch, jcfg, params


@functools.lru_cache(maxsize=None)
def _jax_energy_forces(precision):
    batch, jcfg, params = _model_case()
    cfg = dataclasses.replace(jcfg, precision=precision)
    e, f = jax.jit(lambda p, b: jforces(p, cfg, b, SHAPE["max_graphs"]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(e), np.asarray(f)


def _port_energy_forces(precision, **kernels):
    batch, _, params = _model_case()
    cfg = MaceConfig(**TINY_KW, interaction_block_n=8, precision=precision, **kernels)
    e, f = tforces(params_from_jax(params), cfg, {k: _t(v) for k, v in batch.items()},
                   SHAPE["max_graphs"])
    return e.numpy(), f.numpy()


@pytest.mark.parametrize("precision", VARIANTS)
def test_energies_and_forces_at_reduced_precision(precision):
    """Model level: the port at bf16 / fp8 against the JAX model at the same
    precision and against the fp32 oracle, within ``PRECISION_TOL``, and
    not bitwise equal to fp32."""
    got = _port_energy_forces(precision)
    for g, w in zip(got, _jax_energy_forces(precision)):
        assert _l2_rel(g, w) <= PRECISION_TOL[precision]
    _within_tol_and_live(got, _jax_energy_forces("fp32"), precision)


@pytest.mark.parametrize("impl", ["fused", "ref"])
def test_energies_and_forces_with_the_plain_impls(impl):
    """``impl`` and ``interaction_impl`` ``fused`` / ``ref`` against the JAX
    model with its Pallas kernels, fp32 (the reference's impl-parity
    bounds, tests/test_torch_mace.py)."""
    e, f = _port_energy_forces("fp32", impl=impl, interaction_impl=impl)
    je, jf = _jax_energy_forces("fp32")
    np.testing.assert_allclose(e, je, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(f, jf, **GRAD_TOL)


def test_unblocked_batch_matches_the_blocked_one():
    """A batch collated without the ``blk_*`` arrays takes the unblocked
    path: energies and forces within 2e-5 of the blocked path's."""
    batch, _, params = _model_case()
    cfg = MaceConfig(**TINY_KW, interaction_block_n=8)
    unblocked = {k: _t(v) for k, v in batch.items() if not k.startswith("blk_")}
    got = tforces(params_from_jax(params), cfg, unblocked, SHAPE["max_graphs"])
    want = _port_energy_forces("fp32")
    _allclose([g.numpy() for g in got], want, **VALUE_TOL)


TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32,
             prefetch=0, ckpt_dir=None, lr=2e-3)


@functools.lru_cache(maxsize=None)
def _jax_losses(precision):
    cfg = JConfig(**TINY_KW, interaction_block_n=8, impl="pallas", interaction_impl="pallas")
    tr = JTrainer(cfg, JTrainerConfig(**TRAIN, precision=precision),
                  JDataset(24, seed=0, max_atoms=24), seed=0)
    init = jax.tree.map(np.asarray, tr.params)
    hist = tr.train(n_epochs=1, max_steps=3)["history"]
    return init, np.asarray([h["loss"] for h in hist])


def test_bf16_training_trajectory_drift():
    """Port of tests/test_precision.py::test_engine_bf16_loss_trajectory_
    drift: 3 steps of the port's ``Trainer`` at bf16 (``TrainerConfig.
    precision``) from the JAX trainer's parameters, against the JAX
    trainer at bf16 and both against the JAX fp32 run, within
    ``PRECISION_TOL["bf16"]``, the port not equal to fp32."""
    init, l32 = _jax_losses("fp32")
    _, jl16 = _jax_losses("bf16")
    cfg = MaceConfig(**TINY_KW, interaction_block_n=8)
    tr = Trainer(cfg, TrainerConfig(**TRAIN, precision="bf16"),
                 SyntheticCFMDataset(24, seed=0, max_atoms=24), seed=0,
                 params=params_from_jax(init), device="cpu")
    assert tr.mace_cfg.precision == "bf16" and tr.mace_cfg.symcon_impl_name == "cuda_bf16"
    l16 = np.asarray([h["loss"] for h in tr.train(n_epochs=1, max_steps=3)["history"]])
    assert np.all(np.isfinite(l16))
    for got, want in ((l16, jl16), (l16, l32), (jl16, l32)):
        drift = np.abs(got - want) / np.abs(want)
        assert drift.max() <= PRECISION_TOL["bf16"], drift
    assert np.abs(l16 - l32).max() > 0.0


def test_trainer_overrides_the_kernel_selection():
    cfg = MaceConfig(**TINY_KW, interaction_block_n=8)
    tcfg = TrainerConfig(**TRAIN, impl="fused", interaction_impl="ref",
                         interaction_bwd_impl="fused", precision="fp32")
    tr = Trainer(cfg, tcfg, SyntheticCFMDataset(8, seed=0, max_atoms=16), device="cpu")
    assert (tr.mace_cfg.impl, tr.mace_cfg.interaction_impl,
            tr.mace_cfg.interaction_bwd_impl) == ("fused", "ref", "fused")
    assert not tr.engine.with_blocking  # ref reads no edge blocking
    with pytest.raises(ValueError, match="no 'fp8' variant"):
        Trainer(cfg, dataclasses.replace(tcfg, precision="fp8"),
                SyntheticCFMDataset(8, seed=0, max_atoms=16), device="cpu")
