"""The assigned input-shape set and per-(arch x shape) input specs.

Port of the JAX package's ``launch/shapes.py``.  Every spec is a tensor on
the meta device: shape and dtype, no allocation.  The dry run places them
on a mesh (``launch/sharding.py``) and traces against them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.model import LM, ArchConfig, State, init_decode_state, init_params

LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"kind": "train",   "seq": 4096,    "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,   "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,   "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288,  "batch": 1},
}

# MACE: the paper's own workload — one 3072-token bin per DP rank.
MACE_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_bins": {"kind": "mace_train", "capacity": 3072, "edge_factor": 24},
}

META = torch.device("meta")


def lm_param_specs(cfg: ArchConfig) -> LM:
    """The port's ``LM`` with every parameter on the meta device (the JAX
    ``eval_shape`` of ``init_params``, one tensor per layer instead of one
    stack per segment)."""
    return init_params(cfg, torch.Generator(), device=META)


def lm_batch_specs(cfg: ArchConfig, shape: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    B, S = shape["batch"], shape["seq"]
    batch = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device=META),
        "labels": torch.empty((B, S), dtype=torch.int32, device=META),
    }
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.empty(
            (B, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.float32, device=META)
    return batch


def lm_decode_state_specs(cfg: ArchConfig, batch: int, max_seq: int) -> State:
    return init_decode_state(cfg, batch, max_seq, device=META)


def shape_skip_reason(cfg: ArchConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return (
            "pure full-attention arch: 512k dense-KV decode is "
            "memory/bandwidth-infeasible; sub-quadratic attention required "
            "(DESIGN.md §7)"
        )
    return None
