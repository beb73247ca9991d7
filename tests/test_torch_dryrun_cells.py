"""The dry run's cells that DTensor could not trace, its memory counter,
and its loop routes (``launch/dryrun.py``, ``roofline/collectives.py``,
``models/loops.py``).

Each mini cell is a REDUCED config on a fake process group of 8 ranks (16
for mixtral), one
per class of cell the production sweep could not trace: heads sharded over
'model' (musicgen), the Mamba scan and its decode (jamba), fewer experts
than 'model' ranks under expert parallelism (mixtral ``--opt``), a batch-1
decode state split over 'pod' alone (xlstm long_500k multi).  Each looped
family then runs full and by its faster route at 4 to 8 iterations: the
FLOPs, collective bytes by kind, collective counts and argument bytes must
be the same.  The file imports nothing of JAX, so the chip machine's torch
can run it too; there (torch 2.11) the mini cells of 8 ranks pass, while
the full-route baselines of the mLSTM and Mamba loops need DTensor
strategies 2.11 lacks (``flip``, ``pad``) and the 16-rank cell fails after
the 8-rank ones (a bmm given shards of the wrong shape): the full-size
sweep is 2.11's check.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import loops, mamba, moe, xlstm
from repro_torch.roofline.collectives import count_collectives, count_flops, count_memory

AXES = ("pod", "data", "model")
R = Replicate()


@pytest.fixture(scope="module")
def world():
    dryrun.fake_world(8)
    yield
    dist.destroy_process_group()


def _cell(arch, kind, batch, seq, mesh_shape, overrides):
    mesh = make_test_mesh(mesh_shape, AXES, device_type="cpu")
    cell = dryrun.build_lm_cell(arch, None, mesh, overrides, cfg=get_reduced(arch),
                                shape={"kind": kind, "batch": batch, "seq": seq})
    with dryrun.lm_constraints(cell.tmesh, batch, overrides):
        return cell, dryrun.trace_cell(cell, mesh.size())


def _memory_is_whole(rec):
    mem = rec["memory_per_device"]
    assert mem["argument_gb"] == mem["argument_gb_from_placements"] > 0
    assert mem["memory_basis"] == "traced"
    assert mem["peak_gb"] >= mem["argument_gb"] and mem["temp_gb"] > 0
    assert mem["peak_gb"] >= mem["output_gb"] - mem["alias_gb"] >= 0


def test_count_memory_gives_the_hand_reckoned_peak(world):
    """Arguments from the start, each op's outputs until they die, a view
    counted once, a DTensor by its local shard: 4,000-byte ``x``, then
    ``a`` and ``b`` (12,000 live), ``a`` freed, a 4-byte sum; a gradient
    kept by the graph's saved result; a [64, 32] float32 DTensor split 4
    ways is 2,048 bytes a device."""
    x = torch.empty(1000, device="meta")

    def f(x):
        a = x * 2
        b = a + 1
        del a
        return b.view(10, 100), b.sum()

    with count_memory([x]) as mem:
        out = f(x)
    assert (mem.peak, mem.live) == (12000, 8004)
    del out
    assert mem.live == 4000
    y = torch.empty(1000, device="meta", requires_grad=True)
    with count_memory([y]) as mem:
        z = (y * 2).exp()             # the product dies, exp keeps its result
        assert mem.live == 8000
        g, = torch.autograd.grad(z.sum(), [y])
    assert mem.live == 12000 and mem.peak == 16008
    mesh = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
    a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(0), R],
                          src_data_rank=None)
    with count_memory([a]) as mem:
        assert mem.live == 2048
        b = a * 3                     # local shard bytes, not the global 8,192
    assert mem.peak == 4096 and b.to_local().numel() * 4 == 2048


def test_musicgen_traces_with_its_heads_sharded(world):
    """32 KV heads split over 'model' (REDUCED: 4 over 2): the attention
    core runs on each rank's (batch, heads) shard, train and prefill;
    the decode step's cache is split along its slots."""
    tp = {"_tp": True}
    for kind, batch, seq in (("train", 8, 64), ("prefill", 8, 64), ("decode", 8, 128)):
        cell, rec = _cell("musicgen_large", kind, batch, seq, (2, 2, 2), tp)
        assert rec["collectives_per_device"]["total"] > 0 and rec["cost_analysis"]["flops"] > 0
        _memory_is_whole(rec)
        want = "full" if kind == "decode" else "local"
        assert rec["loop_trace"] == want, (kind, rec["loops"])


def test_jamba_traces_its_scan_and_its_long_decode(world):
    """The Mamba chunk loop on local [B, c, di, ds] blocks (train), and the
    batch-1 decode whose state is split over every mesh dim: its
    row-parallel projection is reduced before B, C and dt are sliced."""
    tp = {"_tp": True}
    _, rec = _cell("jamba_v0_1_52b", "train", 8, 32, (2, 2, 2), tp)
    assert rec["loops"]["mamba_chunks"] == "local"
    _memory_is_whole(rec)
    _, rec = _cell("jamba_v0_1_52b", "decode", 1, 256, (2, 2, 2), tp)
    assert rec["collectives_per_device"].get("all-reduce", 0) > 0
    _memory_is_whole(rec)


def test_xlstm_long_decode_split_over_pod_alone_traces_on_the_3d_mesh(world):
    """A (2, 4, 1) mesh: the sLSTM's 4 heads split over pod (2) but not
    pod·data (8), which the flattened trace mesh cannot hold."""
    cell, rec = _cell("xlstm_125m", "decode", 1, 256, (2, 4, 1), {"_tp": True})
    assert cell.tmesh is cell.mesh and cell.tmesh.mesh_dim_names == AXES
    _memory_is_whole(rec)


def _dt(mesh, shape, placements, grad=True):
    t = distribute_tensor(torch.empty(shape, device="meta"), mesh, placements,
                          src_data_rank=None)
    return t.requires_grad_(grad)


def _family(name):
    """(step function of x, x, parameters) on the (4, 2) ("data", "model")
    mesh, batch split over 'data': each family at 4 to 8 iterations."""
    mesh = make_test_mesh((4, 2), ("data", "model"), device_type="cpu")
    B = 8
    if name == "moe_groups":      # 4 groups of 128 tokens, experts split over 'model'
        cfg = dataclasses.replace(get_reduced("mixtral_8x22b"), moe_group_size=128)
        p = {k: _dt(mesh, tuple(v.shape), (R, Shard(0)) if v.dim() == 3 else (R, R))
             for k, v in moe.init_moe(torch.Generator(), cfg).items()}
        return (lambda x: moe.apply_moe(p, cfg, x, group_size=128)[0],
                _dt(mesh, (B, 64, 64), (Shard(0), R)), p)
    if name == "slstm_steps":     # 8 steps
        cfg = get_reduced("xlstm_125m")
        p = {k: _dt(mesh, tuple(v.shape), (R, R))
             for k, v in xlstm.init_slstm(torch.Generator(), cfg).items()}
        return lambda x: xlstm.slstm_train(p, cfg, x), _dt(mesh, (B, 8, 64), (Shard(0), R)), p
    if name == "mlstm_chunks":    # 4 chunks of 8
        cfg = get_reduced("xlstm_125m")
        p = {k: _dt(mesh, tuple(v.shape), (R, R))
             for k, v in xlstm.init_mlstm(torch.Generator(), cfg).items()}
        return (lambda x: xlstm.mlstm_train(p, cfg, x, chunk=8),
                _dt(mesh, (B, 32, 64), (Shard(0), R)), p)
    cfg = get_reduced("jamba_v0_1_52b")       # mamba_chunks: 4 chunks of 8
    p = {k: _dt(mesh, tuple(v.shape), (R, R))
         for k, v in mamba.init_mamba(torch.Generator(), cfg).items()}
    return (lambda x: mamba.mamba_train(p, cfg, x, chunk=8),
            _dt(mesh, (B, 32, 64), (Shard(0), R)), p)


def _counts(name, mode):
    fn, x, p = _family(name)
    leaves = [x] + list(p.values())
    ep = (R, Shard(0))
    moe.set_ep_sharding(ep, ep) if name == "moe_groups" else None
    loops.reset_routes()
    try:
        with set_checkpoint_early_stop(False), implicit_replication(), loops.trace_mode(mode), \
                count_memory(leaves) as mem, count_collectives() as coll, count_flops() as fl:
            y = checkpoint(fn, x, use_reentrant=False)    # the model's remat
            grads = torch.autograd.grad(y.sum(), leaves)
            del y, grads
    finally:
        moe.set_ep_sharding(None)
    return dict(flops=fl.flops, bytes=coll.result(), counts=dict(coll.counts),
                argument=sum(t.to_local().numel() * 4 for t in leaves), peak=mem.peak,
                route=loops.routes().get(name, "full"))


@pytest.mark.parametrize("name,baseline,route", [
    ("moe_groups", "local", "scaled"), ("slstm_steps", "local", "scaled"),
    ("mlstm_chunks", "full", "local"), ("mamba_chunks", "full", "local")])
def test_loop_routes_count_what_every_iteration_counts(world, name, baseline, route):
    """The faster route's FLOPs, collective bytes by kind, collective counts
    and argument bytes equal the baseline's exactly.  The scaled loops
    against every iteration on the same route (each MoE group's combine
    gathers on local shards in both; run through DTensor, the sLSTM's
    first step's zero state is a plain tensor, replicated, so step 0
    counts its whole batch).  Peaks: a local loop's is the full one's less the excess
    of that replicated zero state over its shard; a scaled loop gives an
    estimate, at or above the peak of every iteration, within 5%."""
    got, want = _counts(name, "fast"), _counts(name, baseline)
    assert got["route"] == route
    for key in ("flops", "bytes", "counts", "argument"):
        assert got[key] == want[key], key
    if route == "scaled":
        assert want["peak"] <= got["peak"] <= 1.05 * want["peak"]
    else:
        # the zero carry built whole (B = 8 rows) where a shard holds 2
        cfg = get_reduced("jamba_v0_1_52b" if name == "mamba_chunks" else "xlstm_125m")
        if name == "mamba_chunks":
            rows = 2 * cfg.d_model * cfg.mamba_d_state * 4
        else:
            dh = cfg.d_model // cfg.n_heads
            rows = cfg.n_heads * (dh * dh + dh + 1) * 4
        assert 0 <= want["peak"] - got["peak"] <= 6 * rows


def test_mixtral_opt_pads_its_experts_over_more_model_ranks(world):
    """4 experts over 8 'model' ranks under expert parallelism: padded to 8
    with zero experts, held and computed, where DTensor refused the uneven
    split.  A (1, 2, 8) mesh of 16 ranks, 16 rows: torch 2.11's DTensor
    fails on the size-1 data dim that (1, 1, 8) would flatten to, and
    torch 2.13's backward on 8 rows (a view it gives a shard of the wrong
    shape).  Last in the file: it starts a world of 16 and then of 8 again,
    and a mesh made before that is not used after it."""
    ep = {"_tp": True, "_ep": True, "_ep_weights": True}
    dryrun.fake_world(16)
    try:
        _, rec = _cell("mixtral_8x22b", "train", 16, 64, (1, 2, 8), ep)
    finally:
        dryrun.fake_world(8)
    _memory_is_whole(rec)
    cfg = get_reduced("mixtral_8x22b")
    d, f, C = cfg.d_model, cfg.d_ff, moe.capacity(cfg, 16 * 64, cfg.moe_capacity_factor)
    # the three expert einsums of one padded expert a rank, forward only
    assert rec["cost_analysis"]["flops"] >= cfg.n_layers * 3 * 2 * C * d * f
