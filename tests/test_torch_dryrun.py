"""Port parity, the dry run and what it measures with: traced cells on a
small fake mesh (``launch/dryrun.py``), the dispatcher-level collective
and FLOP counts and the materialization guard (``roofline/collectives.py``),
``roofline_terms`` and ``mace_cell_cost`` (``roofline/``), against the JAX
package where it has the number.

The counterpart of ``tests/test_dryrun_small.py::test_mini_multipod_dryrun``
makes its own asserts (it does not lean on that JAX test), on a ``(2, 2,
2)`` ``("pod", "data", "model")`` mesh over a fake process group of 8.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs.mace_cfm import CONFIG as JMACE
from repro.roofline.analytic import mace_cell_cost as jmace_cost
from repro_torch.configs import get_reduced
from repro_torch.configs.mace_cfm import CONFIG as MACE
from repro_torch.configs.mace_cfm import REDUCED as MACE_REDUCED
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.interaction import InteractionSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.kernels import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline import HW, RECOMMENDATION, mace_cell_cost, roofline_terms
from repro_torch.roofline.collectives import count_collectives, count_flops, out_shapes

REPO = Path(__file__).resolve().parents[1]
B, S, S_DECODE = 8, 64, 128
KERNEL_NAMES = ("symcon_fwd", "symcon_bwd", "tp_scatter_fwd", "tp_gather_bwd", "symcon_dbl",
                "tp_dbl_scatter", "tp_dbl_gather")


@pytest.fixture(scope="module")
def mesh():
    dryrun.fake_world(8)
    yield make_test_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    dist.destroy_process_group()


def _granite():
    return dataclasses.replace(get_reduced("granite_3_2b"), remat=True)


def _trace(cell, overrides=None, batch=B):
    with dryrun.lm_constraints(cell.tmesh, batch, overrides or {}):
        return dryrun.trace_cell(cell, 8)


@pytest.fixture(scope="module")
def mini_cells(mesh):
    """The JAX mini dry run's two cells: a REDUCED granite train step with
    remat (``tp_fsdp``: TP forced on, as the JAX test does below 1 B
    parameters) on B x S = 8 x 64, and a decode step of the same model with
    bf16 weights, TP-resident, against an 8 x 128 cache."""
    tp = {"_tp": True}
    train = dryrun.build_lm_cell("granite_3_2b", None, mesh, tp, cfg=_granite(),
                                 shape={"kind": "train", "batch": B, "seq": S})
    decode = dryrun.build_lm_cell("granite_3_2b", None, mesh, tp, cfg=_granite(),
                                  shape={"kind": "decode", "batch": B, "seq": S_DECODE})
    return {"train": _trace(train, tp), "decode": _trace(decode, tp)}


def test_mini_multipod_dryrun(mini_cells):
    train, decode = mini_cells["train"], mini_cells["decode"]
    assert train["collectives_per_device"].get("all-reduce", 0) > 0
    assert train["collectives_per_device"]["total"] > 0
    assert train["cost_analysis"]["flops"] > 0
    assert decode["collectives_per_device"]["total"] > 0
    assert decode["cost_analysis"]["flops"] > 0
    for rec in (train, decode):
        mem = rec["memory_per_device"]
        assert mem["argument_gb"] == mem["argument_gb_from_placements"] > 0
        assert mem["temp_gb"] > 0 and mem["peak_gb"] >= mem["argument_gb"]
        assert rec["roofline"]["recommendation"] == RECOMMENDATION[rec["roofline"]["dominant"]]
        assert rec["kernel_launches"] == dict.fromkeys(KERNEL_NAMES, 0)


JAX_BYTES = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.lm_train_step import opt_state_specs
from repro.launch.sharding import (lm_batch_shardings, lm_param_shardings,
                                   lm_param_shardings_inference, lm_state_shardings)
from repro.launch.shapes import lm_param_specs, sds
from repro.models.model import init_decode_state

B, S, SD = %d, %d, %d
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))

def nbytes(specs, shardings, dtype=None):
    return sum(int(np.prod(sh.shard_shape(s.shape))) * np.dtype(dtype or s.dtype).itemsize
               for s, sh in zip(jax.tree.leaves(specs), jax.tree.leaves(shardings)))

cfg = dataclasses.replace(get_reduced("granite_3_2b"), remat=True)
p = lm_param_specs(cfg)
psh = lm_param_shardings(mesh, p, tp=True)
m, v = opt_state_specs(p)
batch = {"tokens": sds((B, S), jnp.int32), "labels": sds((B, S), jnp.int32)}
train = nbytes(p, psh) + nbytes(m, psh) + nbytes(v, psh) + nbytes(batch, lm_batch_shardings(mesh, batch))
cd = dataclasses.replace(cfg, param_dtype=jnp.bfloat16)
pd = lm_param_specs(cd)
st = jax.eval_shape(lambda: init_decode_state(cd, B, SD))
tok = {"t": sds((B, 1), jnp.int32)}
# every parameter at the configured bf16 (see the test's docstring)
decode = (nbytes(pd, lm_param_shardings_inference(mesh, pd, tp=True), jnp.bfloat16)
          + nbytes(st, lm_state_shardings(mesh, st, B)) + nbytes(tok, lm_batch_shardings(mesh, tok)))
print("RESULT " + json.dumps({"train": train, "decode": decode}))
""" % (B, S, S_DECODE)


@pytest.mark.slow  # a subprocess device mesh
def test_argument_bytes_are_the_jax_shard_shapes(mini_cells):
    """``argument_gb`` of both mini cells is the sum of the JAX
    ``shard_shape`` bytes of the same cell (parameters, m, v and batch; the
    inference parameters, decode state and tokens).  The decode cell's
    parameters are counted at the configured ``param_dtype=bf16``: the JAX
    ``make_dense`` scales by a ``np.float64``, which promotes its bf16
    draws to float32, so the JAX serving cells hold their dense weights in
    float32; the port's are bf16, as configured (ROADMAP queue C)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_BYTES], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])
    for kind in ("train", "decode"):
        assert round(mini_cells[kind]["memory_per_device"]["argument_gb"] * 1e9) == want[kind], kind


def test_ddp_and_mace_cells_reduce_their_gradients_once(mesh):
    """The manual-DP cell (REDUCED xlstm, ``_ddp``): plain, one all-reduce
    of one flat buffer (the gradients and the loss) over the data group;
    compressed, the scales, the payload and the loss.  The MACE cell
    (REDUCED config, one rank's bin): the engine's one all-reduce of the
    flat gradient over the world, ``2 (g-1)/g`` times its bytes."""
    cfg = get_reduced("xlstm_125m")
    shape = {"kind": "train", "batch": B, "seq": 32}
    n_params = sum(p.numel() for p in dryrun.lm_param_specs(cfg).parameters())
    for compress, calls in ((False, 1), (True, 3)):
        cell = dryrun.build_lm_cell("xlstm_125m", None, mesh,
                                    {"_ddp": True, "_compress": compress}, cfg=cfg, shape=shape)
        rec = _trace(cell, {"_ddp": True})
        assert rec["collective_counts"] == {"all-reduce": calls}
        g = 4  # the data group of the flattened (pod·data, model) mesh
        if not compress:
            assert rec["collectives_per_device"]["all-reduce"] == 2 * (g - 1) / g * 4 * (n_params + 1)
        assert rec["cost_analysis"]["flops"] > 0
    cell = dryrun.build_mace_cell(mesh, mcfg=MACE_REDUCED, spec={"capacity": 48, "edge_factor": 4})
    rec = dryrun.trace_cell(cell, 8)
    n_params = sum(t.numel() for t in dryrun._leaves(cell.args[0]))
    assert rec["collective_counts"] == {"all-reduce": 1}
    assert rec["collectives_per_device"]["all-reduce"] == 2 * 7 / 8 * 4 * n_params
    assert rec["kernel_launches"] == dict.fromkeys(KERNEL_NAMES, 0)  # plain versions on meta
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory_per_device"]["argument_gb"] == rec["memory_per_device"][
        "argument_gb_from_placements"]


def test_xlstm_traces_under_dtensor_with_its_gate_from_pointwise_ops(mesh):
    """REDUCED xlstm as DTensors (``replicate``, its default below 1 B
    parameters, and ``tp_fsdp``): forward and backward trace, although
    ``F.logsigmoid``'s backward has no DTensor strategy."""
    cfg = get_reduced("xlstm_125m")
    for overrides in ({}, {"_tp": True}):
        cell = dryrun.build_lm_cell("xlstm_125m", None, mesh, overrides, cfg=cfg,
                                    shape={"kind": "train", "batch": B, "seq": 32})
        rec = _trace(cell, overrides)
        assert rec["cost_analysis"]["flops"] > 0


def test_three_d_cells_trace_on_the_flattened_mesh(mesh):
    """A (pod, data, model) cell traces on (pod·data, model): the same
    ranks, each leaf's pod and data placements one; a leaf split over pod
    or data alone is refused."""
    tmesh = dryrun.trace_mesh(mesh)
    assert tmesh.mesh_dim_names == ("data", "model") and tuple(tmesh.mesh.shape) == (4, 2)
    assert tmesh.mesh.flatten().tolist() == mesh.mesh.flatten().tolist()
    assert dryrun._on(tmesh, mesh, {"w": (Shard(0), Shard(0), Shard(1))}) == {
        "w": (Shard(0), Shard(1))}
    with pytest.raises(ValueError, match="alone"):
        dryrun._on(tmesh, mesh, [(Shard(0), Replicate(), Replicate())])


def test_count_collectives_is_exact_on_known_collectives(mesh):
    """Per-device bytes by ``hlo.py``'s ring factors, over a fake group of
    8: a DTensor's Partial -> Replicate all-reduce over the flattened data
    axis (g = 4) after its all-gather over model (g = 2), a
    ``dist.all_reduce`` over the world
    (g = 8), a functional all-gather and reduce-scatter over pod (g = 2);
    and one device's FLOPs: a DTensor matmul whose output is split over
    the whole mesh, global over the mesh size, and one on replicated
    operands, whole (every device repeats it)."""
    tmesh = dryrun.trace_mesh(mesh)  # (4, 2)
    a = distribute_tensor(torch.empty(256, 1024, device="meta"), tmesh, [Shard(1), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(1024, 2048, device="meta"), tmesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    r = distribute_tensor(torch.empty(64, 128, device="meta"), tmesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    pod = mesh.get_group("pod")
    with count_collectives() as coll, count_flops() as fl:
        y = a @ w                                       # Partial over data, Shard(1) on model
        r @ r.T                                         # Replicate: no collective
        y.full_tensor()
        dist.all_reduce(torch.ones(1000))
        funcol.wait_tensor(funcol.all_gather_tensor(torch.ones(10, 4), 0, pod))
        funcol.wait_tensor(funcol.reduce_scatter_tensor(torch.ones(8, 4), "sum", 0, pod))
    full = 256 * 2048 * 4                               # y's bytes once gathered
    gathered = full * 1 / 2 + 20 * 4 * 4 * 1 / 2         # (g-1)/g x result, g = 2
    reduced = full * 2 * 3 / 4 + 1000 * 4 * 2 * 7 / 8    # 2(g-1)/g x result, g = 4, 8
    scattered = 4 * 4 * 4 * 1                           # (g-1) x result, g = 2
    assert coll.result() == {"all-gather": gathered, "all-reduce": reduced,
                             "reduce-scatter": scattered,
                             "total": gathered + reduced + scattered}
    assert coll.counts == {"all-gather": 2, "all-reduce": 2, "reduce-scatter": 1}
    assert fl.flops == 2 * 256 * 1024 * 2048 / 8 + 2 * 64 * 128 * 64


def test_roofline_terms_dominance():
    """``tests/test_roofline.py::test_roofline_terms_dominance`` on the
    card's constants, which are the data sheet's: the NVLink rate is 450
    GB/s each way."""
    assert HW().link_bw == 450e9
    out = roofline_terms(flops=1e19, hbm_bytes=1e12, collective_bytes_per_device=1e9, chips=256)
    assert out["dominant"] == "compute_s"
    assert out["roofline_fraction"] == pytest.approx(1.0)
    out2 = roofline_terms(flops=1e12, hbm_bytes=1e12, collective_bytes_per_device=1e12, chips=256)
    assert out2["dominant"] == "collective_s"
    assert out2["collective_s"] == 1e12 / 450e9
    fp32 = roofline_terms(flops=67e12, hbm_bytes=0, collective_bytes_per_device=0, chips=1,
                          dtype="fp32")
    assert fp32["compute_s"] == pytest.approx(1.0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n_bins", [1, 256])
def test_mace_cell_cost_is_the_jax_one(n_bins, fused):
    got = mace_cell_cost(MACE, n_bins, 3072, 24, fused=fused)
    want = jmace_cost(JMACE, n_bins, 3072, 24, fused=fused)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_fused_interaction_never_materializes_edge_messages():
    """The port of ``tests/test_interaction.py``'s acceptance guard: the
    ``ref`` impl produces the per-edge ``[E, k, d_out]`` message tensor,
    the ``fused`` impl never does."""
    spec = InteractionSpec(TPSpec(sh_spec(2), lspec(0, 1), lspec(0, 1, 2)), 4.0, 8)
    E, n_atoms, k = 64, 16, 4
    rng = np.random.default_rng(2)
    args = (torch.from_numpy(rng.standard_normal((E, spec.tp.y_spec.dim), np.float32)),
            torch.from_numpy(rng.standard_normal((n_atoms, k, spec.tp.h_spec.dim), np.float32)),
            torch.from_numpy(rng.standard_normal((E, spec.tp.n_paths, k), np.float32)),
            torch.from_numpy(rng.integers(0, n_atoms, E).astype(np.int32)),
            torch.from_numpy(rng.integers(0, n_atoms, E).astype(np.int32)),
            torch.from_numpy(rng.random(E) < 0.9))
    edge_msgs = (E, k, spec.tp.out_spec.dim)
    assert edge_msgs in out_shapes(registry.resolve("interaction", "ref", spec), *args)
    assert edge_msgs not in out_shapes(registry.resolve("interaction", "fused", spec), *args)
