"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production meshes, on the meta device, and record its placement, bytes,
FLOPs and collective traffic per device.

Port of the JAX package's ``launch/dryrun.py``.  The JAX dry run lowers and
compiles each cell for 256 or 512 forced host devices; the port has no
compiler to ask, so it traces one step instead: a fake process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``, whose
collectives move nothing), the cell's parameters, optimizer state and
batch (or decode state) as DTensors on the meta device, placed by
``launch/sharding.py``, and one step under ``implicit_replication``,
``count_memory``, ``count_collectives`` and ``count_flops``
(``roofline/collectives.py``).  Nothing is allocated and nothing is
launched: the devices it measures do not exist, so this is not a CPU
fallback of any entry point.

Memory is one device's live bytes during the step (``count_memory``):
``peak_gb`` the most, the arguments included; ``temp_gb`` the peak less
the arguments; ``output_gb`` the storages of what the step returns and
``alias_gb`` those of them that are arguments' (parameters updated in
place), the JAX record's keys.  The JAX train cells donate parameters, m
and v; the port updates parameters in place and replaces each m and v
entry, so the step holds what its caller does (the arguments, from the
start) and no more.

Loops (``models/loops.py``) run on local shards where they exchange nothing
and, on meta, a long loop traces three iterations and scales the rest:
the record's ``loop_trace`` says which (``"full"``, ``"local"`` or
``"scaled"``, the last any loop took; ``loops`` by loop).

The production meshes are 2-D and 3-D; DTensor's sharding propagation on a
3-D mesh took over 120 s for one attention einsum (torch 2.13), so a
3-D ``("pod", "data", "model")`` cell is traced on the 2-D ``(pod·data,
model)`` mesh over the same ranks in the same order wherever every leaf
shards pod and data together (``dp_axes``): each leaf's blocks and groups
are then the same.  A cell with a leaf split over pod or data alone (a
batch-1 decode state whose heads split over pod only) is traced on the 3-D
mesh itself.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mace_cfm --mesh multi

Results append incrementally to ``experiments/dryrun_results_torch.json``
(cells already present are skipped unless --force), so the sweep is
resumable.  ``--jobs N --timeout S`` runs N cells at once, each in its own
process, and records a cell that takes longer than S seconds as failed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 7 --timeout 300
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.lm_train_step import (
    make_lm_train_step,
    make_lm_train_step_ddp,
    opt_state_specs,
    rank_rows,
)
from repro_torch.launch.mesh import (PRODUCTION_MESHES, dp_axes, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.shapes import (
    LM_SHAPES,
    MACE_SHAPES,
    META,
    lm_batch_specs,
    lm_decode_state_specs,
    lm_param_specs,
    shape_skip_reason,
)
from repro_torch.launch.sharding import (
    distribute_params,
    lm_batch_shardings,
    lm_param_shardings,
    lm_param_shardings_inference,
    lm_state_shardings,
    local_shape,
    mace_batch_shardings,
    mace_param_shardings,
    to_placements,
    tp_enabled,
)
from repro_torch.models import loops, moe
from repro_torch.models import model as lm_model
from repro_torch.roofline.analysis import RECOMMENDATION, roofline_terms
from repro_torch.roofline.analytic import lm_cell_cost, mace_cell_cost
from repro_torch.roofline.collectives import count_collectives, count_flops, count_memory

RESULTS_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_results_torch.json"
)
MEMORY_NOTE = ("one device's live storages during the traced step (local shards and plain "
               "tensors, from each op's outputs until they die, the arguments included): "
               "argument_gb the parameters, m, v and the batch or state; peak_gb the most "
               "live; temp_gb = peak_gb - argument_gb; output_gb what the step returns, "
               "alias_gb the part of it that is the arguments' storages. Not counted: the "
               "allocator's rounding and fragmentation, library workspaces, and collective "
               "buffers outside the tensors DTensor returns")
FLOPS_NOTE = ("one device's, counted per dispatched op by FlopCounterMode's formulas: a "
              "DTensor op at global shapes over the mesh dims its output is split over "
              "(replicated work counts whole), a plain-tensor op (one rank's) as it is")


@dataclasses.dataclass
class Cell:
    """One traced cell: ``fn(*args)`` runs the step; ``arguments`` are the
    tensors a device holds (for ``argument_gb``, and live from the start
    of the step for ``peak_gb``) and ``declared`` the ``(global shape,
    dtype, placements)`` of each on ``mesh`` (for the same bytes from the
    rules); ``tmesh`` is the mesh it is traced on."""
    fn: Any
    args: tuple
    cost: Dict[str, float]
    dtype: str
    arguments: list
    declared: list
    mesh: Any
    tmesh: Any = None


def fake_world(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks (a
    group of another size is torn down first)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def trace_mesh(mesh, *placement_trees):
    """The mesh a cell is traced on: ``mesh`` itself, or for a 3-D mesh the
    2-D ``("data", "model")`` one whose data axis is pod·data, unless a
    leaf of ``placement_trees`` splits over pod or data alone."""
    names = mesh.mesh_dim_names
    if len(names) == 2 or any(pod != data for tree in placement_trees
                              for pod, data, _ in _leaves(tree)):
        return mesh
    return make_test_mesh((mesh.size(0) * mesh.size(1), mesh.size(2)), ("data", "model"),
                          device_type=mesh.device_type)


def _on(tmesh, mesh, placements):
    """A placements tree of ``mesh`` for ``tmesh`` (see the module docstring)."""
    if tmesh is mesh:
        return placements
    if isinstance(placements, dict):
        return {k: _on(tmesh, mesh, v) for k, v in placements.items()}
    if isinstance(placements, list):
        return [_on(tmesh, mesh, v) for v in placements]
    pod, data, model = placements
    if pod != data:
        raise ValueError(f"placements {placements} split over pod or data alone")
    return (data, model)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not (tree and hasattr(tree[0], "is_shard")):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _declare(tensors, placements):
    return [(tuple(t.shape), t.dtype, p) for t, p in zip(_leaves(tensors), _leaves(placements))]


def _nbytes(t) -> int:
    local = t.to_local() if isinstance(t, DTensor) else t
    return local.numel() * local.element_size()


def argument_bytes(cell: Cell) -> int:
    """What one device holds: the local shards of the cell's tensors."""
    return sum(_nbytes(t) for t in cell.arguments)


def declared_bytes(cell: Cell) -> int:
    """The same from the rules: every tensor's local shard shape on the
    production mesh, from its global shape and placements."""
    total = 0
    for shape, dtype, placements in cell.declared:
        n = 1
        for s in (local_shape(cell.mesh, shape, placements) if cell.mesh else shape):
            n *= s
        total += n * torch.empty((), dtype=dtype).element_size()
    return total


def build_lm_cell(arch: str, shape_name: str, mesh, overrides: Dict[str, Any], *,
                  cfg=None, shape=None) -> Cell:
    """The cell of ``arch``'s config (or ``cfg``) at ``LM_SHAPES[shape_name]``
    (or ``shape``) on ``mesh``."""
    overrides = overrides or {}
    cfg = cfg or get_config(arch)
    shape = shape or LM_SHAPES[shape_name]
    kind = shape["kind"]
    if kind in ("prefill", "decode"):
        # deployment reality: serving keeps bf16 weights, TP-resident
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    model_overrides = {k: v for k, v in overrides.items() if not k.startswith("_")}
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    cost = lm_cell_cost(cfg, shape)

    params = lm_param_specs(cfg)
    names = [n for n, _ in params.named_parameters()]
    tp = overrides.get("_tp", tp_enabled(cfg))
    if kind in ("prefill", "decode"):
        p_pl = lm_param_shardings_inference(mesh, params, tp=tp)
    else:
        p_pl = lm_param_shardings(mesh, params, tp=tp, mode=overrides.get("_mode"))
    B, S = shape["batch"], shape["seq"]

    if kind == "train":
        batch = lm_batch_specs(cfg, shape)
        b_pl = lm_batch_shardings(mesh, batch)
        tmesh = trace_mesh(mesh, p_pl, b_pl)
        ddp = overrides.get("_ddp")
        if ddp:
            # manual DP: every rank holds the whole model, m and v, and its rows
            p_pl = {n: to_placements(mesh, ()) for n in names}
        else:
            distribute_params(params, tmesh, _on(tmesh, mesh, p_pl))
        m, v = opt_state_specs(params)
        pls = [p_pl[n] for n in names]
        declared = (_declare([p for _, p in params.named_parameters()], pls)
                    + _declare(list(m.values()) + list(v.values()), pls * 2)
                    + _declare(batch, b_pl))
        if ddp:
            # one DP group per model-axis position, as the JAX shard_map's
            # reduction over the dp axes
            group = tmesh.get_group("data")
            fn = make_lm_train_step_ddp(cfg, group, compress=bool(overrides.get("_compress")))
            held = rank_rows(batch, dist.get_rank(group), dist.get_world_size(group))
        else:
            batch = distribute_params(batch, tmesh, _on(tmesh, mesh, b_pl))
            held = batch
            fn = make_lm_train_step(cfg, micro_batches=overrides.get("_micro", 1))
        args = (params, m, v, batch, 0)
        arguments = [p for _, p in params.named_parameters()] + list(m.values()) \
            + list(v.values()) + _leaves(held)
        return Cell(fn, args, cost, "bf16", arguments, declared, mesh, tmesh)

    declared = _declare([p for _, p in params.named_parameters()], [p_pl[n] for n in names])
    if kind == "prefill":
        inputs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
        if cfg.n_prefix_embeds:
            inputs["prefix_embeds"] = torch.empty(
                (B, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.float32, device=META)
        i_pl = lm_batch_shardings(mesh, inputs)
        tmesh = trace_mesh(mesh, p_pl, i_pl)
        distribute_params(params, tmesh, _on(tmesh, mesh, p_pl))
        arguments = [p for _, p in params.named_parameters()]
        declared += _declare(inputs, i_pl)
        inputs = distribute_params(inputs, tmesh, _on(tmesh, mesh, i_pl))
        arguments += _leaves(inputs)

        def fn(p, inp):
            with torch.no_grad():
                return lm_model.forward_prefill(p, cfg, inp["tokens"], inp.get("prefix_embeds"))

        return Cell(fn, (params, inputs), cost, "bf16", arguments, declared, mesh, tmesh)

    state = lm_decode_state_specs(cfg, B, S)
    s_pl = lm_state_shardings(mesh, state, B)
    tokens = {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META)}
    t_pl = lm_batch_shardings(mesh, tokens)
    tmesh = trace_mesh(mesh, p_pl, s_pl, t_pl)
    distribute_params(params, tmesh, _on(tmesh, mesh, p_pl))
    arguments = [p for _, p in params.named_parameters()]
    declared += _declare(state, s_pl) + _declare(tokens, t_pl)
    state = distribute_params(state, tmesh, _on(tmesh, mesh, s_pl))
    tokens = distribute_params(tokens, tmesh, _on(tmesh, mesh, t_pl))
    arguments += _leaves(state) + _leaves(tokens)

    def fn(p, s, t, pos):
        with torch.no_grad():
            return lm_model.decode_step(p, s, cfg, t["tokens"], pos)

    return Cell(fn, (params, state, tokens, S - 1), cost, "bf16", arguments, declared, mesh,
                tmesh)


def build_mace_cell(mesh, shape_name: str = "train_bins", *, mcfg=None, spec=None) -> Cell:
    """One rank's training step on its own bin, in the paper's DDP layout:
    every device of the production world is a rank of the port's
    ``DataParallelEngine`` (one flat data group), parameters, m and v
    replicated, and the step's one collective is the engine's all-reduce of
    the flat gradient.  The kernels are the plain PyTorch impls (``fused``):
    the CUDA kernels have no meta form.  ``mcfg`` and ``spec`` stand in
    for the paper's config and ``MACE_SHAPES[shape_name]``."""
    from repro_torch.bridge import flatten, unflatten
    from repro_torch.configs.mace_cfm import CONFIG
    from repro_torch.core.mace import init_mace, weighted_loss
    from repro_torch.train.engine import flat_mean
    from repro_torch.train.optimizer import adamw, apply_updates, tree_map

    mcfg = dataclasses.replace(mcfg or CONFIG, impl="fused", interaction_impl="fused")
    spec = spec or MACE_SHAPES[shape_name]
    cap, ef = spec["capacity"], spec["edge_factor"]
    world = mesh.size()
    N, E, G = cap, cap * ef, 256
    dp_mesh = make_test_mesh((world,), ("data",), device_type=mesh.device_type)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    bin_ = {
        "species": meta((N,), torch.int32),
        "positions": meta((N, 3), torch.float32),
        "node_mask": meta((N,), torch.bool),
        "senders": meta((E,), torch.int32),
        "receivers": meta((E,), torch.int32),
        "edge_mask": meta((E,), torch.bool),
        "graph_id": meta((N,), torch.int32),
        "energy": meta((G,), torch.float32),
        "forces": meta((N, 3), torch.float32),
    }
    params = tree_map(lambda t: t.to(META), init_mace(mcfg, torch.Generator().manual_seed(0)))
    m = tree_map(lambda t: torch.zeros_like(t), params)
    v = tree_map(lambda t: torch.zeros_like(t), params)
    p_pl = mace_param_shardings(dp_mesh, params)
    global_bins = {k: meta((world,) + tuple(t.shape), t.dtype) for k, t in bin_.items()}
    declared = (_declare(params, p_pl) + _declare(m, p_pl) + _declare(v, p_pl)
                + _declare(global_bins, mace_batch_shardings(dp_mesh, global_bins)))
    opt = adamw(5e-3)

    def step(params, m, v, batch, step_idx):
        leaves = {k: t.requires_grad_(True) for k, t in flatten(params).items()}
        loss, _ = weighted_loss(unflatten(leaves), mcfg, batch, G)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            grads = flat_mean(grads, None, world)
            updates, state = opt.update(unflatten(grads), {"m": m, "v": v}, params, step_idx)
        return apply_updates(params, updates), state["m"], state["v"], loss.detach()

    cost = mace_cell_cost(mcfg, world, cap, ef)
    arguments = _leaves(params) + _leaves(m) + _leaves(v) + _leaves(bin_)
    return Cell(step, (params, m, v, bin_, 0), cost, "fp32", arguments, declared, dp_mesh)


def trace_single_device(cfg, shape: Dict[str, Any], lr: float = 3e-4) -> Dict[str, Any]:
    """One device's training step of ``cfg`` on a packed batch of
    ``shape`` (tokens, labels, positions and segments), every tensor plain
    on the meta device: ``trace_cell``'s record of the step the card runs
    (``make_lm_train_step``), to hold its traced peak against a measured
    one."""
    params = lm_param_specs(cfg)
    m, v = opt_state_specs(params)
    B, S = shape["batch"], shape["seq"]
    batch = {k: torch.empty((B, S), dtype=torch.int32, device=META)
             for k in ("tokens", "labels", "positions", "segments")}
    arguments = ([p for _, p in params.named_parameters()] + list(m.values())
                 + list(v.values()) + list(batch.values()))
    declared = [(tuple(t.shape), t.dtype, ()) for t in arguments]
    cell = Cell(make_lm_train_step(cfg, lr=lr), (params, m, v, batch, 0),
                lm_cell_cost(cfg, shape), "bf16", arguments, declared, None)
    del params, m, v, batch, arguments   # the cell holds them (an m or v entry is replaced)
    return trace_cell(cell, 1)


@contextlib.contextmanager
def lm_constraints(tmesh, batch_size: int, overrides: Dict[str, Any]):
    """The JAX dry run's model constraints while a cell traces: the
    residual stream pinned to pure-DP placements (B > 1, not under DDP or
    ``_no_act_constraint``), and with ``_ep`` the experts' tokens (and with
    ``_ep_weights`` their weights) to 'model'-on-E."""
    try:
        if (batch_size > 1 and not overrides.get("_no_act_constraint")
                and not overrides.get("_ddp")):
            lm_model.set_activation_sharding(to_placements(tmesh, (dp_axes(tmesh), None, None)))
        if overrides.get("_ep"):
            ep = to_placements(tmesh, ("model", None, None))
            moe.set_ep_sharding(ep, ep if overrides.get("_ep_weights") else None)
        yield
    finally:
        lm_model.set_activation_sharding(None)
        moe.set_ep_sharding(None)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def trace_cell(cell: Cell, chips: int) -> Dict[str, Any]:
    """Run the cell's step once under the counters; the record's
    ``trace_s``, ``memory_per_device``, ``cost_analysis``,
    ``collectives_per_device``, ``collective_counts``, ``loop_trace``,
    ``loops``, ``analytic``, ``roofline`` and ``kernel_launches`` (each
    CUDA kernel's launches during the step: none, on meta).  Raises when
    the local shards' bytes differ from the placements'.  Lets go of
    ``cell.arguments``: from the start of the step only the caller's
    references (``cell.args``) hold them."""
    from repro_torch.launch.train import kernel_launches

    arg, want = argument_bytes(cell), declared_bytes(cell)
    if arg != want:
        raise AssertionError(f"local shards hold {arg} bytes, the placements {want}")
    if any(isinstance(t, DTensor) for t in cell.arguments):
        from torch.distributed.tensor.experimental import implicit_replication
        ctx = implicit_replication()
    else:
        ctx = contextlib.nullcontext()
    held = set(loops.storage_bytes(cell.arguments))
    mem = count_memory(cell.arguments)
    cell.arguments = None
    before = kernel_launches()
    loops.reset_routes()
    t0 = time.perf_counter()
    # a checkpointed region's recompute runs whole: it cannot stop early
    # inside a scaled loop's last iteration, so neither route stops early
    with ctx, set_checkpoint_early_stop(False), mem, count_collectives() as coll, \
            count_flops() as fl:
        out = cell.fn(*cell.args)
    rec: Dict[str, Any] = {"trace_s": time.perf_counter() - t0}
    rec["kernel_launches"] = {k: n - before[k] for k, n in kernel_launches().items()}
    routes = loops.routes()
    rec["loops"] = routes
    rec["loop_trace"] = max(routes.values(), key=("full", "local", "scaled").index,
                            default="full")
    outs = loops.storage_bytes(_tensors(out))
    del out
    scaled = [k for k, r in routes.items() if r == "scaled"]
    peak = None if scaled else mem.peak / 1e9
    rec["memory_per_device"] = {
        "argument_gb": arg / 1e9, "argument_gb_from_placements": want / 1e9,
        "output_gb": sum(outs.values()) / 1e9,
        "alias_gb": sum(b for k, b in outs.items() if k in held) / 1e9,
        "temp_gb": None if peak is None else peak - arg / 1e9, "peak_gb": peak,
        "memory_basis": ("traced" if not scaled else
                         f"scaled loops ({', '.join(scaled)}): their skipped iterations are "
                         "not traced, so no peak is given; peak_gb_estimate stands in the "
                         "bytes iteration 1 kept and the most iterations 1 and n - 1 rose "
                         "above their start for each skipped one (models/loops.py), and "
                         "holds iteration n - 1's input gradients together"),
        "note": MEMORY_NOTE}
    if scaled:
        rec["memory_per_device"]["peak_gb_estimate"] = mem.peak / 1e9
    rec["cost_analysis"] = {"flops": fl.flops, "note": FLOPS_NOTE}
    rec["collectives_per_device"] = coll.result()
    rec["collective_counts"] = dict(coll.counts)
    cost = cell.cost
    rec["analytic"] = cost
    rl = roofline_terms(
        flops=cost["flops"], hbm_bytes=cost["hbm_bytes"],
        collective_bytes_per_device=rec["collectives_per_device"]["total"],
        chips=chips, dtype=cell.dtype)
    rl["model_flops_ratio"] = cost["model_flops"] / cost["flops"] if cost["flops"] else 0.0
    rl["recommendation"] = RECOMMENDATION[rl["dominant"]]
    rec["roofline"] = rl
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str, overrides=None) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False}
    multi = mesh_name == "multi"
    shape, _ = PRODUCTION_MESHES[multi]
    chips = 1
    for s in shape:
        chips *= s
    rec["chips"] = chips

    if arch != "mace_cfm":
        reason = shape_skip_reason(get_config(arch), shape_name)
        if reason:
            rec.update(ok=True, skipped=reason)
            return rec

    overrides = overrides or {}
    t0 = time.perf_counter()
    try:
        fake_world(chips)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        constraints = contextlib.nullcontext()
        if arch == "mace_cfm":
            cell = build_mace_cell(mesh, shape_name)
        else:
            cell = build_lm_cell(arch, shape_name, mesh, overrides)
            constraints = lm_constraints(cell.tmesh, LM_SHAPES[shape_name]["batch"], overrides)
        rec["build_s"] = time.perf_counter() - t0
        with constraints:
            rec.update(trace_cell(cell, chips))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def load_results(path: str = RESULTS_PATH) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: Dict[str, Any], path: str = RESULTS_PATH) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=float)


def cell_key(arch, shape, mesh):
    return f"{arch}|{shape}|{mesh}"


# best-known per-arch training overrides from the JAX package's hillclimb
OPTIMIZED_OVERRIDES = {
    "xlstm_125m": {"_ddp": True, "_compress": True},
    "granite_3_2b": {"_mode": "fsdp"},
    "qwen2_5_3b": {"_mode": "fsdp"},
    "musicgen_large": {"_mode": "fsdp"},
    "gemma3_4b": {"_mode": "fsdp"},
    "qwen3_moe_235b_a22b": {"_ep": True, "_ep_weights": True},
    "mixtral_8x22b": {"_ep": True, "_ep_weights": True},
    "jamba_v0_1_52b": {"_ep": True, "_ep_weights": True},
}


def _report(key: str, rec: Dict[str, Any]) -> None:
    status = "OK" if rec.get("ok") else f"FAIL ({rec.get('error')})"
    if rec.get("skipped"):
        status = "SKIP"
    coll = rec.get("collectives_per_device", {})
    print(
        f"  {key} -> {status} wall={rec.get('wall_s', 0):.1f}s "
        f"trace={rec.get('trace_s', 0):.1f}s "
        f"arg={rec.get('memory_per_device', {}).get('argument_gb', 0):.3f}GB "
        f"peak={rec.get('memory_per_device', {}).get('peak_gb')}GB "
        f"loops={rec.get('loop_trace')} "
        f"flops={rec.get('cost_analysis', {}).get('flops', 0):.4g} "
        f"coll={coll.get('total', 0) / 1e6:.1f}MB/dev "
        f"{json.dumps({k: v for k, v in coll.items() if k != 'total'})}",
        flush=True,
    )


def _largest_kind(coll) -> str:
    kinds = {k: v for k, v in coll.items() if k != "total"}
    if not kinds:
        return "none"
    kind = max(kinds, key=kinds.get)
    return f"{kind} {kinds[kind] / coll['total']:.0%}"


def _peak(rec) -> str:
    mem = rec["memory_per_device"]
    if mem.get("peak_gb") is not None:
        return f"{mem['peak_gb']:.2f}"
    return f"~{mem['peak_gb_estimate']:.2f}"


SUMMARY_COLUMNS = [
    ("trace s", lambda r: f"{r['trace_s']:.1f}"),
    ("loops", lambda r: r.get("loop_trace", "full")),
    ("argument GB", lambda r: f"{r['memory_per_device']['argument_gb']:.3f}"),
    ("peak GB", _peak),
    ("TFLOP", lambda r: f"{r['cost_analysis']['flops'] / 1e12:.4g}"),
    ("collective GB", lambda r: f"{r['collectives_per_device']['total'] / 1e9:.4g}"),
    ("largest kind", lambda r: _largest_kind(r["collectives_per_device"])),
]


def summary(results: Dict[str, Any]) -> str:
    """A markdown table of the results, a row per (architecture, shape,
    overrides) with each column's single / multi values: ``trace_s``, the
    loop route, argument and peak GB a device (``~`` a scaled cell's
    estimate), FLOPs and collective GB a device and the largest kind's
    share of them; the skipped and failed cells after it."""
    rows: Dict[tuple, Dict[str, Dict[str, Any]]] = {}
    skipped, failed = [], []
    for key, rec in sorted(results.items()):
        arch, shape, mesh, *opt = key.split("|")
        name = key.replace("|", " ")
        if rec.get("skipped"):
            skipped.append(name)
            continue
        if not rec.get("ok"):
            failed.append(f"{name}: {rec.get('error', '')[:120]}")
        rows.setdefault((arch, shape + (" --opt" if opt else "")), {})[mesh] = rec
    out = ["| cell (single / multi) | " + " | ".join(c for c, _ in SUMMARY_COLUMNS) + " |",
           "| --- " * (len(SUMMARY_COLUMNS) + 1) + "|"]
    for (arch, shape), recs in sorted(rows.items()):
        values = [" / ".join("—" if m not in recs else fn(recs[m]) if recs[m].get("ok")
                             else "failed" for m in ("single", "multi"))
                  for _, fn in SUMMARY_COLUMNS]
        out.append(f"| {arch} {shape} | " + " | ".join(values) + " |")
    if skipped:
        out.append(f"\nSkipped ({len(skipped)}): {', '.join(skipped)}.")
    if failed:
        out.append(f"\nFailed ({len(failed)}): " + "; ".join(failed) + ".")
    return "\n".join(out)


def _run_in_child(arch, shape, mesh_name, opt, args, root) -> Dict[str, Any]:
    """One cell as its own ``python -m repro_torch.launch.dryrun`` process
    (its own fake world and results file), under ``args.timeout``."""
    key = cell_key(arch, shape, mesh_name) + ("|opt" if opt else "")
    path = os.path.join(root, key.replace("|", "-") + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_name, "--force", "--results", path] + (["--opt"] if opt else [])
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
    except subprocess.TimeoutExpired:
        rec["error"] = f"trace did not finish within {args.timeout} s ({args.jobs} cells at once)"
        return rec
    return load_results(path).get(key) or dict(
        rec, error=f"the process exited {proc.returncode}: {proc.stderr[-1500:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument(
        "--opt", action="store_true",
        help="apply best-known hillclimb overrides; results keyed '|opt'",
    )
    ap.add_argument("--results", default=RESULTS_PATH,
                    help="the results file (one per process when cells run at once)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in its own process (1: one after another, "
                         "in this process)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a cell may take with --jobs above 1 (then recorded as failed)")
    ap.add_argument("--summary", action="store_true",
                    help="print the results file as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(load_results(args.results)))
        return 0

    archs = [args.arch] if args.arch else ARCH_IDS + ["mace_cfm"]
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    results = load_results(args.results)
    todo = []
    for arch in archs:
        shapes = (
            [args.shape]
            if args.shape
            else (list(MACE_SHAPES) if arch == "mace_cfm" else list(LM_SHAPES))
        )
        for shape in shapes:
            for mesh_name in meshes:
                key = cell_key(arch, shape, mesh_name)
                if args.opt:
                    if not OPTIMIZED_OVERRIDES.get(arch) or shape.startswith(
                            ("decode", "prefill", "long")):
                        continue  # optimized overrides target train cells
                    key += "|opt"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[skip cached] {key}")
                    continue
                todo.append((key, arch, shape, mesh_name))

    def one(cell):
        key, arch, shape, mesh_name = cell
        if args.jobs > 1:
            return key, _run_in_child(arch, shape, mesh_name, args.opt, args, root)
        print(f"[run] {key}", flush=True)
        overrides = OPTIMIZED_OVERRIDES[arch] if args.opt else None
        rec = run_cell(arch, shape, mesh_name, overrides=overrides)
        if args.opt:
            rec["overrides"] = overrides
        return key, rec

    failed = 0
    with tempfile.TemporaryDirectory() as root, ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for key, rec in (pool.map(one, todo) if args.jobs > 1 else map(one, todo)):
            results[key] = rec
            save_results(results, args.results)
            failed += not rec.get("ok")
            _report(key, rec)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
