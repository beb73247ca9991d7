"""Config registry of the port: one module per assigned architecture (+ the
paper's own MACE CFM workload, ``mace_cfm``, and MACE-MP-0 large,
``mace_mp0_large``).  ``get_config(name)`` returns
the full published config; ``get_reduced(name)`` the same family scaled down
for CPU tests.  A copy of the JAX package's ``configs/__init__.py``, with
``torch`` dtypes in the configs.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.model import ArchConfig

ARCH_IDS = [
    "internvl2_26b",
    "musicgen_large",
    "qwen3_14b",
    "qwen2_5_3b",
    "granite_3_2b",
    "gemma3_4b",
    "xlstm_125m",
    "mixtral_8x22b",
    "qwen3_moe_235b_a22b",
    "jamba_v0_1_52b",
]

# canonical CLI ids (--arch <id>)
CLI_ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "musicgen-large": "musicgen_large",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-3-2b": "granite_3_2b",
    "gemma3-4b": "gemma3_4b",
    "xlstm-125m": "xlstm_125m",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def _module(name: str):
    name = CLI_ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).REDUCED


def get_edge_factor(name: str) -> int:
    """Edge slots per atom of a bin for a MACE configuration's graphs."""
    return _module(name).EDGE_FACTOR


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
