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

from repro_torch.configs.mace_cfm import CONFIG
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.core.symmetric_contraction import SymConSpec
from repro_torch.data.blocking import block_edges, static_n_tiles
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


SYMCON_CASES = {
    # name: (in irreps, nu_max, N, k); N * k = 960 is not a multiple of the
    # kernels' block of 128 threads
    "nu1": ((0, 1, 2, 3), 1, 40, 24),
    "nu2": ((0, 1, 2, 3), 2, 40, 24),
    "nu3_in012": ((0, 1, 2), 3, 40, 24),
    "paper_n256_k128": ((0, 1, 2, 3), 2, 256, 128),
}


def _symcon_operands(dev, name):
    in_ls, nu, N, k = SYMCON_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    spec = SymConSpec(lspec(*in_ls), lspec(0, 1), nu)
    A, W, G = (_randn(rng, dev, N, spec.in_spec.dim, k),
               _randn(rng, dev, N, sck.p_total_of(spec), k),
               _randn(rng, dev, N, spec.out_spec.dim, k))
    return spec, A, W, G


@pytest.mark.parametrize("name", sorted(SYMCON_CASES))
def test_symcon_kernels_match_plain(dev, name):
    spec, A, W, G = _symcon_operands(dev, name)
    if name == "paper_n256_k128":
        assert spec == CONFIG.symcon_spec()
    before = sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches
    _close([sck.symcon_fwd(A, W, spec)], [sck.symcon_plain(A, W, spec)])
    _close(sck.symcon_bwd(A, W, G, spec), sck.symcon_bwd_plain(A, W, G, spec))
    torch.cuda.synchronize()
    assert (sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches) == (before[0] + 1, before[1] + 1)


def test_symcon_kernels_are_bitwise_deterministic(dev):
    """Two launches on the same inputs give bit-identical outputs: every sum
    runs in the generated header's fixed order, with no atomics."""
    spec, A, W, G = _symcon_operands(dev, "paper_n256_k128")
    assert torch.equal(sck.symcon_fwd(A, W, spec), sck.symcon_fwd(A, W, spec))
    for a, b in zip(sck.symcon_bwd(A, W, G, spec), sck.symcon_bwd(A, W, G, spec)):
        assert torch.equal(a, b)


def _paper_blocking(rng, n_atoms=64):
    """The paper's 32-atom x 128-slot tiles over dataset-like degrees plus a
    hub atom of degree 300 (three tiles sharing a base); a padding tile
    follows."""
    deg = rng.integers(8, 40, n_atoms)
    deg[5] = 300
    receivers = np.repeat(np.arange(n_atoms), deg).astype(np.int32)
    rng.shuffle(receivers)
    mask = np.ones(receivers.size, bool)
    n_tiles = static_n_tiles(receivers.size, n_atoms, 32, 128) + 1
    return block_edges(receivers, mask, n_atoms, block_n=32, block_e=128, n_tiles=n_tiles)


def _tp_case(name):
    """(spec, k, blocking arrays (local, valid, n_tiles, block_n, epb))."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("h0_k8", "h01_k40", "lmax4_out01234_k40"):
        h_ls, k = ((0,), 8) if name == "h0_k8" else ((0, 1), 40)
        if name == "lmax4_out01234_k40":
            # d_sh = d_out = 25: the forward's dynamic shared memory passes
            # 48 KB (2 KB per output component), so the entry point raises
            # the kernel's limit before the launch
            spec = TPSpec(sh_spec(4), lspec(*h_ls), lspec(0, 1, 2, 3, 4))
            assert tpk.spec_dims(spec) == (25, 4, 13, 25)
        else:
            spec = TPSpec(sh_spec(3), lspec(*h_ls), lspec(0, 1, 2, 3))
        n_atoms, E = 20, 160
        receivers = np.concatenate([np.full(40, 3), rng.integers(0, n_atoms, E - 40)])
        mask = rng.random(E) < 0.9
        blk = block_edges(receivers.astype(np.int32), mask, n_atoms, block_n=8, block_e=16)
        local, valid = blk.local_rcv.copy(), blk.valid.copy()
    else:
        spec, k = CONFIG.tp_spec_at(1), 128
        blk = _paper_blocking(rng)
        local, valid = blk.local_rcv.copy(), blk.valid.copy()
        epb = blk.epb
        if name == "paper_layer1_straddle":
            # receivers of 10 slots each from the start of tile 0: runs cross
            # the forward's 32-slot ballot groups (slots 30..39) and the
            # 16-slot segments of a full tile (slots 10..19)
            local[:epb] = np.minimum(np.arange(epb) // 10, 31)
            valid[:epb] = True
            assert local[31] == local[32] == 3 and local[15] == local[16] == 1
        elif name == "paper_layer1_masked_tile":
            valid[epb:2 * epb] = False  # a tile of real receivers, all masked
        elif name == "paper_layer1_unsorted":
            perm = rng.permutation(epb)  # a receiver's slots come back later
            local[:epb], valid[:epb] = local[:epb][perm], valid[:epb][perm]
    assert not valid[-blk.epb:].any(), "expected a padding tile"
    return spec, k, local, valid, blk.n_atom_tiles, blk.block_n, blk.epb


TP_CASES = ["h0_k8", "h01_k40", "lmax4_out01234_k40", "paper_layer1_k128",
            "paper_layer1_straddle", "paper_layer1_masked_tile", "paper_layer1_unsorted"]


def _tp_operands(dev, name):
    spec, k, local, valid, T, bn, epb = _tp_case(name)
    rng = np.random.default_rng(len(name))
    E_p = T * epb
    ops = dict(
        Y=_randn(rng, dev, E_p, spec.y_spec.dim),
        h=_randn(rng, dev, E_p, spec.h_spec.dim, k),
        R=_randn(rng, dev, E_p, spec.n_paths, k),
        G=_randn(rng, dev, T * bn, spec.out_spec.dim, k),
        local=torch.from_numpy(local.astype(np.int32)).to(dev),
        valid=torch.from_numpy(valid).to(dev),
    )
    return spec, ops, dict(n_tiles=T, block_n=bn), valid, epb


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_kernels_match_plain_with_hub_and_padding(dev, name):
    spec, o, kw, valid, epb = _tp_operands(dev, name)
    args = (o["Y"], o["h"], o["R"], o["local"], o["valid"], spec)
    before = tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches
    out = tpk.tp_scatter(*args, **kw)
    _close([out], [tpk.tp_scatter_plain(*args, **kw)])
    bn = kw["block_n"]
    tiles = out.reshape(kw["n_tiles"], bn, *out.shape[1:])
    for t in np.nonzero(~valid.reshape(-1, epb).any(axis=1))[0]:
        assert float(tiles[t].abs().max()) == 0.0  # fully masked tiles: exact zeros
    got = tpk.tp_gather_bwd(o["G"], *args, **kw)
    _close(got, tpk.tp_gather_bwd_plain(o["G"], *args, **kw))
    for g in got:
        assert float(g[torch.from_numpy(~valid).to(dev)].abs().max()) == 0.0  # masked slots
    torch.cuda.synchronize()
    assert (tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches) == (
        before[0] + 1, before[1] + 1)


def test_tp_kernels_are_bitwise_deterministic(dev):
    """Two launches on the same inputs give bit-identical outputs: no float
    atomics, fixed summation orders."""
    spec, o, kw, _, _ = _tp_operands(dev, "paper_layer1_k128")
    args = (o["Y"], o["h"], o["R"], o["local"], o["valid"], spec)
    assert torch.equal(tpk.tp_scatter(*args, **kw), tpk.tp_scatter(*args, **kw))
    for a, b in zip(tpk.tp_gather_bwd(o["G"], *args, **kw),
                    tpk.tp_gather_bwd(o["G"], *args, **kw)):
        assert torch.equal(a, b)


def test_wrappers_refuse_cpu_cuda_mix(dev):
    spec = SymConSpec(lspec(0, 1), lspec(0, 1), 2)
    A = torch.zeros(8, 4, 8, device=dev)
    with pytest.raises(ValueError):
        sck.symcon_fwd(A, torch.zeros(8, sck.p_total_of(spec), 8), spec)


# ---------------------------------------------------------------------------
# second order and a training step
# ---------------------------------------------------------------------------


def _grad_close(got, want):
    """The reference's gradient bound, 2e-4 of the largest magnitude: the
    card's ``index_add_`` sums in no fixed order."""
    for g, w in zip(got, want):
        w = w.to(g.device)
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-4 * scale


def _second_order_symcon(device, spec, A, species, weights, G, c):
    """Gradient with respect to (A, weights) of <c, d<B, G>/dA>."""
    from repro_torch.kernels.symmetric_contraction.ops import symcon_cuda

    a = A.to(device).requires_grad_(True)
    w = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
    B = symcon_cuda(a, species.to(device), w, spec)
    (da,) = torch.autograd.grad((B * G.to(device)).sum(), a, create_graph=True)
    return torch.autograd.grad((da * c.to(device)).sum(), [a, *w.values()])


def test_symcon_grad_of_grad_matches_the_cpu(dev):
    spec = CONFIG.symcon_spec()
    rng = np.random.default_rng(11)
    N, k, n_species = 100, CONFIG.channels, 5
    cpu = torch.device("cpu")
    A = _randn(rng, cpu, N, k, spec.in_spec.dim)
    G = _randn(rng, cpu, N, k, spec.out_spec.dim)
    c = _randn(rng, cpu, N, k, spec.in_spec.dim)
    species = torch.from_numpy(rng.integers(0, n_species, N))
    weights = {f"w_L{L}_nu{nu}": _randn(rng, cpu, *shp) for (L, nu), shp in
               spec.weight_shapes(n_species, k).items()}
    before = sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches
    got = _second_order_symcon(dev, spec, A, species, weights, G, c)
    torch.cuda.synchronize()
    # the first order on the card is the kernels' (one launch each); the
    # derivative of the backward is the plain twin's
    assert (sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches) == (before[0] + 1, before[1] + 1)
    _grad_close(got, _second_order_symcon(torch.device("cpu"), spec, A, species,
                                          weights, G, c))


def _second_order_interaction(device, spec, ops, blocking):
    """Gradient with respect to (Y, h, R) of <c, d<A, g>/d(Y, h, R)>."""
    from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op

    ins = [ops[n].to(device).requires_grad_(True) for n in ("Y", "h", "R")]
    ints = [ops[n].to(device) for n in ("senders", "receivers", "edge_mask")]
    A = interaction_cuda_op(*ins, *ints, spec=spec,
                            blocking={k: v.to(device) for k, v in blocking.items()})
    first = torch.autograd.grad((A * ops["g"].to(device)).sum(), ins, create_graph=True)
    scalar = sum((d * ops["c" + n].to(device)).sum() for d, n in zip(first, "YhR"))
    return torch.autograd.grad(scalar, ins)


@pytest.mark.parametrize("layer", [0, 1])
def test_interaction_grad_of_grad_matches_the_cpu(dev, layer):
    """The paper's widths, a hub atom spanning tiles and a padding tile."""
    from repro_torch.data.blocking import blocking_from_batch, blocking_to_batch

    spec = CONFIG.interaction_spec_at(layer)
    rng = np.random.default_rng(layer)
    n_atoms, k = 64, CONFIG.channels
    deg = rng.integers(8, 40, n_atoms)
    deg[5] = 300
    receivers = np.repeat(np.arange(n_atoms), deg).astype(np.int32)
    rng.shuffle(receivers)
    E = receivers.size
    edge_mask = rng.random(E) < 0.95
    blk = block_edges(receivers, edge_mask, n_atoms, block_n=32, block_e=128,
                      n_tiles=static_n_tiles(E, n_atoms, 32, 128) + 1)
    assert (blk.tile_base == 0).sum() >= 3 and not blk.valid[-blk.epb:].any()
    cpu = torch.device("cpu")
    tp = spec.tp
    ops = dict(Y=_randn(rng, cpu, E, tp.y_spec.dim), h=_randn(rng, cpu, n_atoms, k, tp.h_spec.dim),
               R=_randn(rng, cpu, E, tp.n_paths, k), g=_randn(rng, cpu, n_atoms, k, tp.out_spec.dim),
               senders=torch.from_numpy(rng.integers(0, n_atoms, E).astype(np.int32)),
               receivers=torch.from_numpy(receivers),
               edge_mask=torch.from_numpy(edge_mask))
    ops.update({"c" + n: torch.randn_like(ops[n]) for n in "YhR"})
    blocking = {k: torch.from_numpy(np.asarray(v))
                for k, v in blocking_from_batch(blocking_to_batch(blk)).items()}
    before = tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches
    got = _second_order_interaction(dev, spec, ops, blocking)
    torch.cuda.synchronize()
    assert (tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    _grad_close(got, _second_order_interaction(cpu, spec, ops, blocking))


def _kernel_launches():
    return np.array([sck.SYMCON_FWD.launches, sck.SYMCON_BWD.launches,
                     tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches])


@pytest.mark.parametrize("n_ranks", [1, 2])
def test_training_step_launches_each_kernel_per_bin(dev, n_ranks):
    """Per bin of a training step: each forward kernel once, each backward
    kernel twice (inside the forces' ``autograd.grad`` and in the loss's
    backward); the second order goes through the plain twins."""
    import dataclasses

    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(CONFIG, channels=16)
    tcfg = TrainerConfig(capacity=128, edge_factor=48, max_graphs=16, n_ranks=n_ranks)
    tr = Trainer(cfg, tcfg, SyntheticCFMDataset(64, seed=0, max_atoms=64), device=dev)
    before = _kernel_launches()
    hist = tr.train(n_epochs=1, max_steps=1)["history"]
    torch.cuda.synchronize()
    assert np.isfinite(hist[0]["loss"])
    assert (_kernel_launches() - before).tolist() == [2 * n_ranks, 4 * n_ranks,
                                                      2 * n_ranks, 4 * n_ranks]


# ---------------------------------------------------------------------------
# the precision variants and the identity-blocked launch
# ---------------------------------------------------------------------------

VARIANTS = ("bf16", "fp8")


def test_rounding_on_card_matches_round_to(dev):
    """Each build's ``round_op`` against the plain ``round_to``, bit for bit:
    ties, subnormals, fp8's 448 / 464 / 465 / 480, the infinities, NaN."""
    from repro_torch.kernels.precision import PRECISIONS, round_to

    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.asarray([0.0, -0.0, 448.0, 464.0, 465.0, -480.0, np.inf, -np.inf, np.nan,
                    1.0625, 1.1875, 1 + 2 ** -8, 2 ** -10, 1.5 * 2 ** -9, 3.3e38], np.float32),
        (rng.standard_normal(20_000) * np.exp(rng.uniform(-14, 8, 20_000))).astype(np.float32)])
    for p in PRECISIONS:
        got = sck.round_on_card(torch.from_numpy(x).to(dev), CONFIG.symcon_spec(), p)
        want = round_to(torch.from_numpy(x), p)
        assert np.array_equal(got.cpu().numpy().view(np.uint32), want.numpy().view(np.uint32)), p


@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("name", sorted(SYMCON_CASES))
def test_symcon_variant_kernels_match_plain(dev, name, precision):
    """The bf16 / fp8 builds against the plain versions at that precision,
    and not the fp32 build's outputs."""
    spec, A, W, G = _symcon_operands(dev, name)
    out = sck.symcon_fwd(A, W, spec, precision)
    _close([out], [sck.symcon_plain(A, W, spec, precision)])
    _close(sck.symcon_bwd(A, W, G, spec, precision),
           sck.symcon_bwd_plain(A, W, G, spec, precision))
    assert not torch.equal(out, sck.symcon_fwd(A, W, spec))


@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("name", TP_CASES)
def test_tp_variant_kernels_match_plain(dev, name, precision):
    """The bf16 / fp8 builds against the plain versions at that precision
    (the forward's messages are formed unfused, in the plain version's
    order, so both round them alike), masked slots and padding tiles exact
    zeros."""
    spec, o, kw, valid, epb = _tp_operands(dev, name)
    args = (o["Y"], o["h"], o["R"], o["local"], o["valid"], spec)
    out = tpk.tp_scatter(*args, **kw, precision=precision)
    _close([out], [tpk.tp_scatter_plain(*args, **kw, precision=precision)])
    assert not torch.equal(out, tpk.tp_scatter(*args, **kw))
    got = tpk.tp_gather_bwd(o["G"], *args, **kw, precision=precision)
    _close(got, tpk.tp_gather_bwd_plain(o["G"], *args, **kw, precision=precision))
    for g in got:
        assert float(g[torch.from_numpy(~valid).to(dev)].abs().max()) == 0.0


@pytest.mark.parametrize("E", [1, 200, 5000])
def test_tp_cuda_identity_launch_matches_the_cpu(dev, E):
    """``tp_cuda`` (both kernels under the identity blocking) on the card
    against the CPU's plain versions: forward and VJP, one launch each."""
    from repro_torch.kernels.channelwise_tp.ops import tp_cuda

    spec, k = CONFIG.tp_spec_at(1), CONFIG.channels
    rng = np.random.default_rng(E)
    cpu = torch.device("cpu")
    ops = [_randn(rng, cpu, E, spec.y_spec.dim), _randn(rng, cpu, E, k, spec.h_spec.dim),
           _randn(rng, cpu, E, spec.n_paths, k)]
    g = _randn(rng, cpu, E, k, spec.out_spec.dim)

    def run(device):
        ins = [t.to(device).requires_grad_(True) for t in ops]
        out = tp_cuda(*ins, spec)
        return [out.detach(), *torch.autograd.grad(out, ins, g.to(device))]

    before = tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert (tpk.TP_SCATTER_FWD.launches, tpk.TP_GATHER_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    _close([t.cpu() for t in got], run(cpu))


@pytest.mark.parametrize("bwd_impl", ["cuda", "fused"])
@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "unblocked"])
def test_interaction_paths_grad_of_grad_match_the_cpu(dev, blocked, bwd_impl):
    """The unblocked path and the fused backward at second order, on the
    card against the CPU, at the paper's layer-1 widths."""
    import dataclasses

    from repro_torch.data.blocking import blocking_from_batch, blocking_to_batch
    from repro_torch.kernels.channelwise_tp.ops import interaction_cuda_op

    spec = dataclasses.replace(CONFIG.interaction_spec_at(1), bwd_impl=bwd_impl)
    rng = np.random.default_rng(7)
    n_atoms, E, k = 40, 1500, CONFIG.channels
    receivers = rng.integers(0, n_atoms, E).astype(np.int32)
    edge_mask = rng.random(E) < 0.95
    cpu = torch.device("cpu")
    tp = spec.tp
    ops = dict(Y=_randn(rng, cpu, E, tp.y_spec.dim), h=_randn(rng, cpu, n_atoms, k, tp.h_spec.dim),
               R=_randn(rng, cpu, E, tp.n_paths, k),
               g=_randn(rng, cpu, n_atoms, k, tp.out_spec.dim),
               senders=torch.from_numpy(rng.integers(0, n_atoms, E).astype(np.int32)),
               receivers=torch.from_numpy(receivers), edge_mask=torch.from_numpy(edge_mask))
    ops.update({"c" + n: torch.randn_like(ops[n]) for n in "YhR"})
    blocking = None
    if blocked:
        blk = block_edges(receivers, edge_mask, n_atoms, block_n=32, block_e=128)
        blocking = {key: torch.from_numpy(np.asarray(v))
                    for key, v in blocking_from_batch(blocking_to_batch(blk)).items()}

    def second_order(device):
        ins = [ops[n].to(device).requires_grad_(True) for n in ("Y", "h", "R")]
        ints = [ops[n].to(device) for n in ("senders", "receivers", "edge_mask")]
        A = interaction_cuda_op(*ins, *ints, spec=spec, blocking=None if blocking is None
                                else {key: v.to(device) for key, v in blocking.items()})
        first = torch.autograd.grad((A * ops["g"].to(device)).sum(), ins, create_graph=True)
        scalar = sum((d * ops["c" + n].to(device)).sum() for d, n in zip(first, "YhR"))
        return torch.autograd.grad(scalar, ins)

    before = tpk.TP_GATHER_BWD.launches
    got = second_order(dev)
    torch.cuda.synchronize()
    assert tpk.TP_GATHER_BWD.launches - before == (1 if bwd_impl == "cuda" else 0)
    _grad_close(got, second_order(cpu))


def test_bf16_training_step_launches_on_the_bf16_libraries(dev):
    """A bf16 training step launches each kernel as an fp32 one does, 2/4/2/4
    per bin, every launch from a bf16 build."""
    import dataclasses

    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.kernels.cuda_lib import precision_define
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(CONFIG, channels=16)
    tcfg = TrainerConfig(capacity=128, edge_factor=48, max_graphs=16, precision="bf16")
    tr = Trainer(cfg, tcfg, SyntheticCFMDataset(64, seed=0, max_atoms=64), device=dev)
    kernels = (sck.SYMCON_FWD, sck.SYMCON_BWD, tpk.TP_SCATTER_FWD, tpk.TP_GATHER_BWD)
    for kern in kernels:
        kern.reset()
    hist = tr.train(n_epochs=1, max_steps=1)["history"]
    torch.cuda.synchronize()
    assert np.isfinite(hist[0]["loss"])
    tag = precision_define("bf16")
    assert [sum(n for h, n in kern.launches_by_header.items() if tag in h)
            for kern in kernels] == [kern.launches for kern in kernels] == [2, 4, 2, 4]


# ---------------------------------------------------------------------------
# serving under CUDA graphs: one graph per bucket
# ---------------------------------------------------------------------------

SERVE_CAPACITIES = (64, 128)


def _serve_setup(impl="cuda"):
    """The paper's specs at 16 channels, random weights from a seed, the
    bucket ladder and a skewed set of molecules."""
    import dataclasses

    from repro_torch.core.mace import init_mace
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.serve import bucket_ladder

    cfg = dataclasses.replace(CONFIG, channels=16, impl=impl, interaction_impl=impl)
    params = init_mace(cfg, torch.Generator().manual_seed(0))
    ladder = bucket_ladder(SERVE_CAPACITIES, edge_factor=48)
    ds = SyntheticCFMDataset(64, seed=1, max_atoms=max(SERVE_CAPACITIES))
    by_size = sorted(range(len(ds)), key=lambda i: int(ds.sizes[i]))
    mols = [ds.get(i) for i in by_size[-4:] + by_size[:12]]
    return cfg, params, ladder, mols


def _bin_for(bucket, mols):
    """As many of ``mols`` as fit ``bucket``, in order."""
    picked, n, e = [], 0, 0
    for m in mols:
        if (n + m.n_atoms <= bucket.max_nodes and e + m.n_edges <= bucket.max_edges
                and len(picked) < bucket.max_graphs):
            picked.append(m)
            n, e = n + m.n_atoms, e + m.n_edges
    return picked


@pytest.mark.parametrize("impl", ["cuda", "fused", "ref"])
def test_replay_matches_eager_per_bucket(dev, impl):
    """Each bucket's graph replayed on a real bin against the eager
    ``mace_energy_forces`` on the same batch, within the kernel tolerance;
    every impl captures; through the cuda impl a replay launches each
    kernel as often as the eager call does."""
    from repro_torch.core.mace import mace_energy_forces
    from repro_torch.serve import bucket_key, make_serve_engine

    cfg, params, ladder, mols = _serve_setup(impl)
    engine = make_serve_engine(cfg, params, ladder, device=dev)
    try:
        assert engine.compile_census() == {bucket_key(b): 1 for b in ladder}
        for bucket in ladder:
            batch, _ = engine.collate(_bin_for(bucket, mols[::-1]), bucket)
            before = _kernel_launches()
            want = mace_energy_forces(engine.params, cfg, batch, bucket.max_graphs)
            torch.cuda.synchronize()
            eager = _kernel_launches() - before
            got = engine.forward(batch, bucket)
            torch.cuda.synchronize()
            replay = _kernel_launches() - before - eager
            _close(got, want)
            assert replay.tolist() == eager.tolist()
            assert eager.tolist() == ([2, 2, 2, 2] if impl == "cuda" else [0, 0, 0, 0])
        assert engine.compile_census() == {bucket_key(b): 1 for b in ladder}
    finally:
        engine.close()


def test_census_stays_one_per_bucket_through_a_mix_and_a_rebuild(dev):
    """A mixed load (ragged tails: bins of one small molecule as well as full
    ones) never recaptures, and the rebuilt engine of a drain-and-rebuild
    has again one graph per bucket."""
    from repro_torch.serve import GraphServer, ServeConfig, bucket_key

    cfg, params, _, mols = _serve_setup()
    server = GraphServer(cfg, params, ServeConfig(
        capacities=SERVE_CAPACITIES, edge_factor=48, n_workers=2, max_wait_s=0.01),
        device=dev)
    try:
        want = {bucket_key(b): 1 for b in server.buckets}
        results = [f.result(timeout=300.0) for f in server.submit_many(mols)]
        results += [server.submit(mols[-1]).result(timeout=300.0)]  # a bin of one
        assert len(results) == len(mols) + 1
        assert server.stats()["compile_census"] == want
        server.drain_and_rebuild()
        results = [f.result(timeout=300.0) for f in server.submit_many(mols)]
        stats = server.stats()
        assert stats["compile_census"] == want and stats["rebuilds"] == 1
        assert stats["served"] == 2 * len(mols) + 1 and stats["failed"] == 0
    finally:
        server.close()


def test_replay_refuses_a_batch_of_another_shape(dev):
    from repro_torch.serve import make_serve_engine

    cfg, params, ladder, mols = _serve_setup()
    engine = make_serve_engine(cfg, params, ladder, device=dev)
    try:
        small, large = ladder
        batch, _ = engine.collate(_bin_for(small, mols), small)
        with pytest.raises(ValueError, match="bucket n128.*array 'species'"):
            engine.forward(batch, large)
        assert engine.compile_census() == {k: 1 for k in engine.compile_census()}
    finally:
        engine.close()


def test_closed_engine_releases_its_graphs(dev):
    from repro_torch.serve import make_serve_engine

    cfg, params, ladder, _ = _serve_setup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    engine = make_serve_engine(cfg, params, ladder, device=dev)
    pools = engine.pool_bytes()
    assert all(n > 0 for n in pools.values()), pools
    held = torch.cuda.memory_reserved()
    engine.close()
    assert engine.compile_census() == {}
    assert torch.cuda.memory_reserved() <= held - sum(pools.values())


# ---------------------------------------------------------------------------
# the autotuner's timing harness on the card
# ---------------------------------------------------------------------------

# the 256-atom serving bucket at the paper's width (edge_factor 48)
HARNESS_SHAPES = {"symcon": dict(N=256, k=128, nu=2), "channelwise_tp": dict(E=12288, k=128),
                  "interaction": dict(E=12288, N=256, k=128)}


@pytest.mark.parametrize("kind", sorted(HARNESS_SHAPES))
def test_time_impl_times_the_cuda_kernels_on_the_card(dev, kind):
    """CUDA-event timings of the cuda impl, forward and forward + first
    backward (both backwards of the interaction), all positive; the
    kernels launched in the timed calls."""
    from repro_torch.kernels import bench as bk

    kernels = ((sck.SYMCON_FWD, sck.SYMCON_BWD) if kind == "symcon"
               else (tpk.TP_SCATTER_FWD, tpk.TP_GATHER_BWD))
    before = [kern.launches for kern in kernels]
    rows = bk.time_impl(kind, "cuda", grad=True, repeats=5, **HARNESS_SHAPES[kind])
    torch.cuda.synchronize()
    assert len(rows) == (3 if kind == "interaction" else 2)
    assert all(r["us"] > 0 and "failed" not in r for r in rows), rows
    assert all(kern.launches > n for kern, n in zip(kernels, before))


def test_out_of_memory_candidate_is_recorded_and_skipped_by_decide(dev):
    """Capped at 4 GiB, the fused interaction at the training bin's shape
    (inputs about 0.8 GiB, each [E, k, nnz] intermediate 6 GiB) runs out of
    memory: its rows carry no time and ``failed``, and ``decide`` picks
    among the measured ones."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import bench as bk

    shape = dict(E=147456, N=3072, k=128)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(4 * 2**30 / total)
    try:
        failed = bk.time_impl("interaction", "fused", grad=True, repeats=2, **shape)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert all(r["us"] is None and r["failed"] == bk.OOM for r in failed), failed
    measured = bk.time_impl("interaction", "cuda", grad=True, repeats=2, block_n=32,
                            block_e=128, **shape)
    run = {"backend": "gpu", "rows": failed + measured}
    d = at.decide("interaction", shape, "gpu", "fwd_bwd", runs=[run],
                  block_candidates=[(32, 128)])
    assert (d.impl, d.source) == ("cuda", "measured")
