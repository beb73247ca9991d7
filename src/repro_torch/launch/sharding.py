"""Partition rules: FSDP x TP (x EP) placements for params, optimizer state,
batches and decode states, per (arch x shape x mesh), as DTensor
placements.

Port of the JAX package's ``launch/sharding.py``.  Scheme:
* params: Megatron TP on the 'model' axis (column-parallel in-projections,
  row-parallel out-projections, expert-parallel MoE when E % model == 0)
  PLUS ZeRO-3 FSDP on the data axes for the other big dimension;
* optimizer moments mirror param placements;
* batches: tokens sharded over DP axes;
* decode states: batch over DP, KV-cache *sequence* over 'model' (flash-
  decoding style); batch-1 long-context shards sequence over every axis.

Every rule is first written as the JAX ``PartitionSpec`` it is (one entry
per tensor dim: ``None``, a mesh axis, or a tuple of axes), divisibility-
checked by :func:`_checked` (an axis that does not divide its dim is
dropped: replicated, never padded), then turned into one DTensor placement
per mesh dim by :func:`to_placements`.  Each function returns one
placement tuple per leaf of the tree it is given: for an ``LM`` a dict by
parameter name, for a decode state a list of per-layer dicts, for a batch
or a MACE tree the same (nested) dicts.

Where the port differs from the JAX trees: the JAX LM stacks a segment's
repeats of a layer into one leaf with a leading (never sharded) axis; the
port has one tensor per layer.  A port leaf's spec is the JAX leaf's spec
without that leading entry, and every rule here is written on the
unstacked shape (``fsdp``'s largest dim is the largest of the layer's own
dims).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

from .mesh import dp_axes

Spec = Tuple[Any, ...]
Placements = Tuple[Placement, ...]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _checked(mesh, shape, spec_axes) -> Spec:
    """Drop axes that don't divide their dim."""
    out = []
    for dim, axes in zip(shape, spec_axes):
        if axes is None:
            out.append(None)
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        keep = []
        for a in ax:
            if dim % _axis_size(mesh, keep + [a]) == 0:
                keep.append(a)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def to_placements(mesh, spec: Spec) -> Placements:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``
    carries that mesh axis, else ``Replicate()``.  A dim split over several
    axes lists them major to minor, which must be the mesh's order: DTensor
    splits a dim over its mesh dims in mesh order, so ``("pod", "data")``
    and ``[Shard(0), Shard(0), ...]`` cut the same blocks."""
    names = list(mesh.mesh_dim_names)
    owner: Dict[str, int] = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [names.index(a) for a in ax]
        if order != sorted(order):
            raise ValueError(f"axes {ax} of dim {d} are not in the mesh's order {names}")
        for a in ax:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards dims {owner[a]} and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def local_shape(mesh, shape, placements: Placements) -> Tuple[int, ...]:
    """The shape of one device's shard (every split even: the rules only
    keep axes that divide)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
            out[p.dim] //= n
    return tuple(out)


def _placed(mesh, shape, axes) -> Placements:
    return to_placements(mesh, _checked(mesh, shape, axes))


def _map_leaves(fn, tree, names=()):
    """``fn(dict-key path, tensor)`` over a tree of dicts and lists (list
    indices are not part of the path, as in the JAX rules' ``names``)."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, names) for v in tree]
    return fn(names, tree)


# --------------------------- LM param rules ---------------------------------

_RULES = [
    # (regex on last path component, rule fn(shape, dp, E_ok) -> axes tuple)
    (r"^embed$",      lambda s, dp, eo: ("model", dp)),
    (r"^head$",       lambda s, dp, eo: (dp, "model")),
    (r"^(wq|wk|wv)$", lambda s, dp, eo: (dp, "model")),
    (r"^wo$",         lambda s, dp, eo: ("model", dp)),
    (r"^(wi|wg)$",    lambda s, dp, eo: (("model", dp, None) if len(s) == 3 else (dp, "model"))),
    # moe experts: [E, d, f]; expert-parallel if divisible else f over model
    (r"^router$",     lambda s, dp, eo: (dp, None)),
    (r"^(b[qkv])$",   lambda s, dp, eo: ("model",)),
    (r"^w_in$",       lambda s, dp, eo: (dp, "model")),
    (r"^w_out$",      lambda s, dp, eo: ("model", dp)),
    (r"^w_bcdt$",     lambda s, dp, eo: ("model", None)),
    (r"^w_dt$",       lambda s, dp, eo: (None, "model")),
    (r"^(conv)$",     lambda s, dp, eo: (None, "model")),
    (r"^(conv_b|dt_bias|D)$", lambda s, dp, eo: ("model",)),
    (r"^A_log$",      lambda s, dp, eo: ("model", None)),
    (r"^wo_gate$",    lambda s, dp, eo: (dp, "model")),
    (r"^(wi_gate|wf|w[if])$", lambda s, dp, eo: (dp, None)),
    (r"^wx$",         lambda s, dp, eo: (dp, "model")),
    (r"^up$",         lambda s, dp, eo: (dp, "model")),
    (r"^down$",       lambda s, dp, eo: ("model", dp)),
]


def _moe_expert_axes(shape, dp, mesh, name):
    """[E, d, f] (wi/wg) or [E, f, d] (wo)."""
    E = shape[0]
    if E % _axis_size(mesh, "model") == 0:
        return ("model", dp, None)
    if name in ("wi", "wg"):
        return (None, dp, "model")
    return (None, "model", dp)


def _pad(axes, core) -> Spec:
    axes = tuple(axes)
    return axes + (None,) * (len(core) - len(axes))


def lm_param_shardings(mesh, params: nn.Module, tp: bool = True,
                       mode: Optional[str] = None) -> Dict[str, Placements]:
    """``{parameter name: placements}`` of an ``LM`` (meta or real).

    ``mode`` (overrides ``tp``):
      * "tp_fsdp"   — Megatron TP on 'model' + ZeRO-3 FSDP on dp (default
                      for >1B models; the huge-model regime);
      * "fsdp"      — no TP: largest dim of every leaf sharded over dp only;
      * "replicate" — pure DDP (small recurrent models whose per-timestep
                      scans would otherwise contain weight-grad collectives).
    """
    dp = dp_axes(mesh)
    if mode is None:
        mode = "tp_fsdp" if tp else "replicate"
    if mode not in ("tp_fsdp", "fsdp", "replicate"):
        raise ValueError(f"unknown mode {mode!r}")

    def one(pname, core):
        name = pname.rsplit(".", 1)[-1]
        in_moe = name in ("wi", "wg", "wo") and len(core) == 3
        if mode == "replicate":
            axes = tuple(None for _ in core)
        elif mode == "fsdp":
            axes = [None] * len(core)
            if core:
                big = core.index(max(core))  # the first largest, as np.argmax
                if core[big] % _axis_size(mesh, dp) == 0 or core[big] > 4 * _axis_size(mesh, dp):
                    axes[big] = dp
            axes = tuple(axes)
        elif in_moe:
            axes = _moe_expert_axes(core, dp, mesh, name)
        else:
            axes = None
            for pat, rule in _RULES:
                if re.match(pat, name):
                    axes = rule(core, dp, True)
                    break
            if axes is None:
                # norms / biases / small leftovers: replicate
                axes = tuple(None for _ in core)
        return _placed(mesh, core, _pad(axes, core))

    return {n: one(n, tuple(p.shape)) for n, p in params.named_parameters()}


def tp_enabled(cfg) -> bool:
    """TP policy: models below ~1B params run pure-DP (TP collectives would
    dominate)."""
    return cfg.param_count() > 1_000_000_000


# --------------------------- inference rules --------------------------------

_INFER_COL = re.compile(r"^(wq|wk|wv|wi|wg|w_in|wx|up|wo_gate|w_dt)$")
_INFER_ROW = re.compile(r"^(wo|w_out|down|w_bcdt)$")


def lm_param_shardings_inference(mesh, params: nn.Module,
                                 tp: bool = True) -> Dict[str, Placements]:
    """Serving-time placements: Megatron TP only — weights stay resident
    and sharded over 'model'; NO FSDP (per-token weight all-gathers would
    cost about the parameters' bytes of link traffic per decode step).
    Huge MoE stacks additionally spread the expert/contraction dim over the
    DP axes so 100B+ params fit."""
    dp = dp_axes(mesh)

    def one(pname, core):
        name = pname.rsplit(".", 1)[-1]
        if not tp:
            axes = tuple(None for _ in core)
        elif name in ("wi", "wg") and len(core) == 3:   # moe [E, d, f]
            if core[0] % _axis_size(mesh, dp) == 0:
                axes = (dp, None, "model")
            else:
                axes = (None, dp, "model")
        elif name == "wo" and len(core) == 3:           # moe [E, f, d]
            if core[0] % _axis_size(mesh, dp) == 0:
                axes = (dp, "model", None)
            else:
                # the JAX rule assigns twice; this second assignment is the
                # one that acts
                axes = (None, "model", dp)
        elif name == "embed":
            axes = ("model", None)
        elif name == "head":
            axes = (None, "model")
        elif _INFER_COL.match(name) and len(core) == 2:
            axes = (None, "model")
        elif _INFER_ROW.match(name) and len(core) == 2:
            axes = ("model", None)
        elif name in ("conv",):
            axes = (None, "model")
        elif name in ("conv_b", "dt_bias", "D", "bq", "bk", "bv"):
            axes = ("model",)
        elif name == "A_log":
            axes = ("model", None)
        else:
            axes = tuple(None for _ in core)
        return _placed(mesh, core, _pad(axes, core))

    return {n: one(n, tuple(p.shape)) for n, p in params.named_parameters()}


# --------------------------- batch / state rules ----------------------------


def lm_batch_shardings(mesh, batch: Mapping[str, Any]) -> Dict[str, Any]:
    dp = dp_axes(mesh)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return to_placements(mesh, ())
        return _placed(mesh, shape, (dp,) + (None,) * (len(shape) - 1))

    return _map_leaves(one, batch)


def lm_state_shardings(mesh, state: Sequence[Mapping[str, Any]], batch_size: int):
    """Decode-state placements (a list of per-layer dicts).  KV sequence
    rides 'model' (B > 1) or all axes (B == 1, long-context)."""
    dp = dp_axes(mesh)
    seq_axes = "model" if batch_size > 1 else tuple(dp) + ("model",)
    b_axes = dp if batch_size > 1 else None

    def one(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if name in ("k", "v"):          # [B, slots, H, dh]
            axes = (b_axes, seq_axes, None, None)
        elif name == "pos":             # [B, slots]
            axes = (b_axes, seq_axes)
        elif name == "h" and len(shape) == 3:   # mamba [B, di, ds], slstm [B, H, dh]
            axes = (b_axes, seq_axes, None)
        elif name == "conv_buf":        # [B, dc-1, di]
            axes = (b_axes, None, "model")
        elif name == "C":               # mlstm [B, H, dh, dh]
            axes = (b_axes, None, None, None)
        else:
            axes = (b_axes,) + (None,) * (len(shape) - 1)
        return _placed(mesh, shape, axes)

    return _map_leaves(one, state)


# --------------------------- MACE rules --------------------------------------


def mace_param_shardings(mesh, params: Mapping[str, Any], channel_tp: bool = False):
    """MACE parameter placements.

    Default (paper-faithful): pure DDP — params replicated, one gradient
    all-reduce per step (§5.1.2 of the paper uses PyTorch DDP).
    ``channel_tp=True`` shards the 128-channel (last) axis over 'model'
    (a beyond-paper hypothesis)."""
    def one(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if (channel_tp and len(shape) >= 2 and shape[-1] >= _axis_size(mesh, "model")
                and shape[-1] % _axis_size(mesh, "model") == 0 and name != "e0"):
            axes = (None,) * (len(shape) - 1) + ("model",)
        else:
            axes = (None,) * len(shape)
        return to_placements(mesh, axes)

    return _map_leaves(one, params)


def mace_batch_shardings(mesh, batch: Mapping[str, Any]):
    """Bins are the DP unit: leading (bins) axis over DP axes."""
    dp = dp_axes(mesh)
    return _map_leaves(lambda names, leaf: _placed(
        mesh, tuple(leaf.shape), (dp,) + (None,) * (leaf.dim() - 1)), batch)


# --------------------------- applying placements ----------------------------


def _distribute(t: torch.Tensor, mesh, placements: Placements):
    return distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)


def distribute_params(tree, mesh, placements):
    """Place a tree on ``mesh``: an ``LM`` in place (each parameter becomes
    a DTensor parameter; returns the module), any other tree of dicts and
    lists (a MACE tree, a batch, a decode state) as a new tree of DTensors.
    Every process must hold the same full tensors (from one seed, or meta):
    each keeps its own shard of them, nothing is sent."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            setattr(mod, leaf, nn.Parameter(_distribute(p, mesh, placements[name]),
                                            requires_grad=p.requires_grad))
        return tree

    def walk(t, pl):
        if isinstance(t, Mapping):
            return {k: walk(v, pl[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, q) for v, q in zip(t, pl)]
        return _distribute(t, mesh, pl)

    return walk(tree, placements)
