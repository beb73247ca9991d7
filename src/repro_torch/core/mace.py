"""MACE (Batatia et al., NeurIPS 2022) in PyTorch: port of the JAX package's
``core/mace.py`` forward, with forces as the positions-gradient.

Structure per interaction layer t:
  1. per-l linear "up" on node features h
  2. radial MLP -> per-path x per-channel TP weights  R_{ji,k,(l1l2l3)}
  3. interaction op (one call through ``kernels.registry``): channelwise
     tensor product + masked scatter-sum over receivers + /avg_num_neighbors
  4. per-l linear on A
  5. symmetric contraction  ->  higher-body-order B_i
  6. message m = per-l linear(B);  h' = m + species-dependent skip(h)
  7. readout: layer < last: linear on invariant block; last: MLP

Total energy  E = sum_i (E0_{z_i} + sum_t readout_t(h_i^t));
forces  F = -dE/dr  via ``torch.autograd.grad``.  Serving takes them
detached (:func:`mace_energy_forces`); training keeps their graph
(:func:`energy_forces_graph`, ``create_graph=True``), so the forces term of
:func:`weighted_loss` makes every step a grad-of-grad, whose second order
runs on kernels on every route: the symmetric contraction's second-order
kernel and the interaction's two (``kernels/*/ops.py``).

Batch layout (static shapes; padding masked) is the JAX package's:
species [N], positions [N, 3], node_mask [N], senders/receivers/edge_mask
[E], graph_id [N], plus the ``blk_*`` edge blocking (``data.blocking``)
that the ``cuda`` interaction impls read (without it they take the
unblocked path: the TP-only kernels' messages, summed over receivers).
:func:`interaction_consumes_blocking` says whether a config's interaction
impl reads it.  Parameters are a nested dict of tensors with the JAX
package's keys (``bridge.py`` converts both ways).

Kernel selection is the JAX package's, under the port's names
(``bridge.JAX_IMPL_NAMES``): ``MaceConfig.impl`` picks the symmetric
contraction, ``interaction_impl`` the interaction op (``ref``, ``fused``,
``cuda`` or a registered name), ``interaction_bwd_impl`` the interaction
backward of the cuda impls (``cuda`` or ``fused``), and ``precision``
rewrites ``cuda`` to its ``cuda_bf16`` / ``cuda_fp8`` variant.  Either
impl may be the ``"auto"`` sentinel, which the build paths (``Trainer``,
``make_engine``, ``ServeEngine``, ``GraphServer``) resolve from the tuning
table (``kernels.autotune.resolve_mace_config``) before the model runs; at
the raw-model level ``interaction_impl="auto"`` follows ``impl``, and a raw
``impl="auto"`` raises when the name is resolved.  One divergence from the
JAX ``MaceConfig``: its defaults are ``impl="fused"`` and
``interaction_impl="auto"``, the port's are ``"cuda"`` for both, so a bare
config runs the kernels on the card.  The JAX ``dtype`` field has no
counterpart: the port's parameters and features are float32, the one dtype
its kernels compute in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import flatten
from repro_torch.data.blocking import blocking_from_batch
from repro_torch.kernels.precision import check_precision
from repro_torch.kernels.registry import get_impl, resolve

from .channelwise_tp import TPSpec
from .interaction import InteractionSpec, resolve_interaction
from .irreps import LSpec, lspec, sh_spec
from .radial import apply_mlp, init_mlp, radial_embedding
from .spherical import spherical_harmonics
from .symmetric_contraction import SymConSpec, init_symcon_weights

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MaceConfig:
    n_species: int = 10
    channels: int = 128                   # k
    hidden_ls: Tuple[int, ...] = (0, 1)   # 128x0e + 128x1o
    sh_lmax: int = 3
    a_ls: Tuple[int, ...] = (0, 1, 2, 3)  # atomic-basis irreps
    correlation: int = 2                  # nu_max (paper §5.2)
    n_interactions: int = 2
    r_max: float = 4.5
    num_bessel: int = 8
    radial_mlp: Tuple[int, ...] = (64, 64, 64)
    readout_mlp: int = 16
    avg_num_neighbors: float = 12.0
    # symmetric-contraction impl: a name in repro_torch.kernels.registry
    # ("ref" | "fused" | "cuda" | registered), or "auto" (resolved by the
    # build paths from the tuning table; a raw forward refuses it)
    impl: str = "cuda"
    # interaction (TP + scatter) impl: a name of the registry's interaction
    # kind, or of its channelwise_tp kind (wrapped in the receiver sum), or
    # "auto": the build paths resolve it from the tuning table (impl, tile
    # geometry and bwd_impl); at the raw-model level it follows ``impl``.
    # "cuda" reads the data pipeline's blk_* arrays when the batch has them
    # and takes the unblocked path when it has not.
    interaction_impl: str = "cuda"
    # backward of the cuda interaction impls: "cuda" = the gather +
    # TP-transpose kernel, "fused" = the VJP of interaction_fused (the JAX
    # package's "pallas" / "xla").  Ignored by ref and fused.
    interaction_bwd_impl: str = "cuda"
    # atom rows per kernel tile; must match BinShape.block_n
    interaction_block_n: int = 32
    # operand precision of the kernels ("fp32" | "bf16" | "fp8"): a reduced
    # precision steers "cuda" to its "cuda_<precision>" variant (operands
    # rounded as loaded, fp32 sums; kernels/precision.py) and rides the
    # InteractionSpec into the interaction kernels.  ref and fused have no
    # reduced-precision variant: asking for one raises when the name is
    # resolved rather than silently running fp32.
    precision: str = "fp32"

    def __post_init__(self):
        check_precision(self.precision)

    @property
    def hidden_spec(self) -> LSpec:
        return LSpec(self.hidden_ls)

    @property
    def a_spec(self) -> LSpec:
        return LSpec(self.a_ls)

    @property
    def sh_spec(self) -> LSpec:
        return sh_spec(self.sh_lmax)

    def h_spec_at(self, layer: int) -> LSpec:
        """Node-feature irreps entering interaction ``layer`` (first layer
        sees the scalar species embedding only)."""
        return lspec(0) if layer == 0 else self.hidden_spec

    def tp_spec_at(self, layer: int) -> TPSpec:
        return TPSpec(self.sh_spec, self.h_spec_at(layer), self.a_spec)

    def symcon_spec(self) -> SymConSpec:
        return SymConSpec(self.a_spec, self.hidden_spec, self.correlation)

    def _with_precision(self, name: str) -> str:
        """Map an impl name to its ``self.precision`` variant: fp32 (or the
        ``"auto"`` sentinel, resolved later by the build paths) leaves it
        alone; a reduced precision rewrites ``"cuda"`` to
        ``"cuda_<precision>"``, accepts a name that already carries the
        suffix, and refuses any other impl, never running fp32 silently."""
        if self.precision == "fp32" or name == "auto" or name.endswith("_" + self.precision):
            return name
        if name == "cuda":
            return f"cuda_{self.precision}"
        raise ValueError(
            f"impl {name!r} has no {self.precision!r} variant; reduced "
            f"precision requires the cuda kernels (got precision={self.precision!r})"
        )

    @property
    def symcon_impl_name(self) -> str:
        return self._with_precision(self.impl)

    @property
    def interaction_impl_name(self) -> str:
        name = self.impl if self.interaction_impl == "auto" else self.interaction_impl
        return self._with_precision(name)

    def interaction_spec_at(self, layer: int) -> InteractionSpec:
        return InteractionSpec(
            self.tp_spec_at(layer), self.avg_num_neighbors,
            self.interaction_block_n, self.interaction_bwd_impl, self.precision,
        )


def interaction_consumes_blocking(mace_cfg: MaceConfig) -> bool:
    """True when the model's interaction impl reads pre-blocked edges: the
    engines then ask collation for the ``blk_*`` arrays.  A name registered
    only as a TP-only kernel (``core.interaction.resolve_interaction``'s
    fallback) reads none."""
    try:
        impl = get_impl("interaction", mace_cfg.interaction_impl_name)
    except KeyError:
        return False
    return impl.consumes_blocking


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _linear_per_l(gen, spec: LSpec, k_in: int, k_out: int) -> Params:
    return {
        f"l{l}_{i}": torch.randn((k_in, k_out), generator=gen) / math.sqrt(k_in)
        for i, l in enumerate(spec.ls)
    }


def _apply_linear_per_l(p: Params, x: torch.Tensor, spec: LSpec) -> torch.Tensor:
    """x: [N, k, dim(spec)] -> same-shaped with per-l channel mixing."""
    outs = []
    for i, (l, sl) in enumerate(spec.slices()):
        outs.append(torch.einsum("nkd,kq->nqd", x[:, :, sl], p[f"l{l}_{i}"]))
    return torch.cat(outs, dim=-1)


def init_mace(cfg: MaceConfig, generator: torch.Generator) -> Params:
    """Random parameters with the JAX ``init_mace``'s shapes and scales, drawn
    from a CPU ``torch.Generator`` (torch cannot reproduce ``jax.random``:
    tests that compare with JAX bridge the JAX parameters instead)."""
    k = cfg.channels
    gen = generator
    params: Params = {
        "embed": torch.randn((cfg.n_species, k), generator=gen)
        / math.sqrt(cfg.n_species),
        "e0": torch.zeros((cfg.n_species,)),  # per-species reference energy
    }
    for t in range(cfg.n_interactions):
        h_spec = cfg.h_spec_at(t)
        tp = cfg.tp_spec_at(t)
        layer: Params = {
            "lin_up": _linear_per_l(gen, h_spec, k, k),
            "radial": init_mlp(
                gen, (cfg.num_bessel, *cfg.radial_mlp, tp.n_paths * k)
            ),
            "lin_a": _linear_per_l(gen, cfg.a_spec, k, k),
            "symcon": init_symcon_weights(gen, cfg.symcon_spec(), cfg.n_species, k),
            "lin_msg": _linear_per_l(gen, cfg.hidden_spec, k, k),
            # species-dependent residual ("sc" in MACE)
            "skip": {
                f"l{l}_{i}": torch.randn((cfg.n_species, k, k), generator=gen)
                / math.sqrt(k)
                for i, l in enumerate(h_spec.ls)
                if l in cfg.hidden_spec.ls
            },
        }
        if t < cfg.n_interactions - 1:
            layer["readout"] = torch.randn((k, 1), generator=gen) / math.sqrt(k)
        else:
            layer["readout_mlp"] = init_mlp(gen, (k, cfg.readout_mlp, 1))
        params[f"layer_{t}"] = layer
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def mace_energy(
    params: Params,
    cfg: MaceConfig,
    species: torch.Tensor,
    positions: torch.Tensor,
    node_mask: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    graph_id: torch.Tensor,
    n_graphs: int,
    blocking: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Total potential energy per graph: [n_graphs]."""
    N = species.shape[0]

    # index_select, whose backward is an index_add_ (advanced indexing's is
    # PyTorch's sort-based indexing backward, most of serving's device time)
    vec = (positions.index_select(0, receivers)
           - positions.index_select(0, senders))             # [E, 3]
    lengths = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
    Y = spherical_harmonics(cfg.sh_lmax, vec)                # [E, dim_sh]
    radial = radial_embedding(lengths, cfg.r_max, cfg.num_bessel)

    # initial node features: species embedding, l=0 block
    h = params["embed"][species][:, :, None]                 # [N, k, 1]
    nmask_n = node_mask.to(positions.dtype)
    h = h * nmask_n[:, None, None]

    site_energy = positions.new_zeros((N,))
    sc_fn = resolve("symcon", cfg.symcon_impl_name, cfg.symcon_spec())

    for t in range(cfg.n_interactions):
        layer = params[f"layer_{t}"]
        h_spec = cfg.h_spec_at(t)
        tp_spec = cfg.tp_spec_at(t)
        int_fn = resolve_interaction(
            cfg.interaction_impl_name, cfg.interaction_spec_at(t)
        )

        h_up = _apply_linear_per_l(layer["lin_up"], h, h_spec)
        R = apply_mlp(layer["radial"], radial).reshape(-1, tp_spec.n_paths, cfg.channels)
        # interaction op: TP + masked scatter to receivers + /avg_num_neighbors
        A = int_fn(Y, h_up, R, senders, receivers, edge_mask,
                   blocking=blocking)                        # [N, k, dim_a]
        A = _apply_linear_per_l(layer["lin_a"], A, cfg.a_spec)

        B = sc_fn(A, species, layer["symcon"])               # [N, k, dim_hidden]
        m = _apply_linear_per_l(layer["lin_msg"], B, cfg.hidden_spec)

        # species-dependent skip (residual) from the *old* h
        skip = torch.zeros_like(m)
        for i, (l, sl_h) in enumerate(h_spec.slices()):
            if l in cfg.hidden_spec.ls:
                W = layer["skip"][f"l{l}_{i}"][species]      # [N, k, k]
                sl_o = cfg.hidden_spec.slice_for(l)
                skip[:, :, sl_o] += torch.einsum("nkd,nkq->nqd", h[:, :, sl_h], W)
        h = (m + skip) * nmask_n[:, None, None]

        inv = h[:, :, cfg.hidden_spec.slice_for(0)][:, :, 0]  # [N, k]
        if t < cfg.n_interactions - 1:
            e_t = (inv @ layer["readout"])[:, 0]
        else:
            e_t = apply_mlp(layer["readout_mlp"], inv)[:, 0]
        site_energy = site_energy + e_t * nmask_n

    site_energy = site_energy + params["e0"][species] * nmask_n
    out = site_energy.new_zeros((n_graphs,))
    return out.index_add(0, graph_id, site_energy)


def _energy_forces(params, cfg, batch, n_graphs, create_graph: bool):
    pos = batch["positions"].detach().requires_grad_(True)
    energy = mace_energy(
        params, cfg,
        batch["species"], pos, batch["node_mask"],
        batch["senders"], batch["receivers"], batch["edge_mask"],
        batch["graph_id"], n_graphs, blocking=blocking_from_batch(batch),
    )
    (grad,) = torch.autograd.grad(energy.sum(), pos, create_graph=create_graph)
    return energy, -grad * batch["node_mask"].to(grad.dtype)[:, None]


def energy_forces_graph(
    params: Params, cfg: MaceConfig, batch: Dict[str, torch.Tensor], n_graphs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy [G], forces [N, 3]) with their graph kept: forces come from
    ``torch.autograd.grad(..., create_graph=True)``, so both can be
    differentiated again with respect to the parameters (the training
    loss).  Needs autograd enabled."""
    return _energy_forces(params, cfg, batch, n_graphs, create_graph=True)


def mace_energy_forces(
    params: Params, cfg: MaceConfig, batch: Dict[str, torch.Tensor], n_graphs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (energy [G], forces [N, 3]), both detached.

    Forces are ``-dE/dr`` from ``torch.autograd.grad`` without
    ``create_graph``; autograd is switched on here, so the call works from
    inside ``torch.no_grad()`` too (never call it under
    ``torch.inference_mode()``, which forbids autograd)."""
    with torch.enable_grad():
        energy, forces = _energy_forces(params, cfg, batch, n_graphs, create_graph=False)
    return energy.detach(), forces


def weighted_loss(
    params: Params,
    cfg: MaceConfig,
    batch: Dict[str, torch.Tensor],
    n_graphs: int,
    energy_weight: float = 1.0,
    forces_weight: float = 100.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Paper §5.2's weighted (energy, forces) loss, differentiable with
    respect to the parameters: (loss, {"loss", "e_rmse", "f_rmse"})."""
    energy, forces = energy_forces_graph(params, cfg, batch, n_graphs)
    nmask = batch["node_mask"].to(energy.dtype)
    nat = torch.clamp(
        energy.new_zeros((n_graphs,)).index_add(0, batch["graph_id"].long(), nmask),
        min=1.0,
    )
    gmask = (nat > 0.5).to(energy.dtype)
    e_err = ((energy - batch["energy"]) / nat) ** 2 * gmask
    f_err = torch.sum((forces - batch["forces"]) ** 2, dim=-1) * nmask
    n_g = torch.clamp(torch.sum(gmask), min=1.0)
    n_at = torch.clamp(torch.sum(nmask), min=1.0)
    loss = energy_weight * torch.sum(e_err) / n_g + forces_weight * torch.sum(
        f_err) / (3.0 * n_at)
    return loss, {"loss": loss, "e_rmse": torch.sqrt(torch.sum(e_err) / n_g),
                  "f_rmse": torch.sqrt(torch.sum(f_err) / (3.0 * n_at))}


def param_count(params: Params) -> int:
    return sum(int(v.numel()) for v in flatten(params).values())
