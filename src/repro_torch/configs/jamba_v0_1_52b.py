"""Jamba-v0.1-52B [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.  [arXiv:2403.19887; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    # period-8 block: attention at position 4 (1:7 attn:mamba), MoE every 2nd
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ff_pattern=("mlp", "moe"),
    n_experts=16, top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    compute_dtype=torch.bfloat16,
    subquadratic=True,   # mostly-mamba: long_500k eligible
)

REDUCED = ArchConfig(
    name="jamba-v0.1-52b-reduced",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ff_pattern=("mlp", "moe"), n_experts=4, top_k=2,
    moe_capacity_factor=4.0,
    mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
    attn_chunk=64, subquadratic=True,
)
