"""Mixtral-8x22B [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128,
    pattern=("swa",), ff_pattern=("moe",),
    window=4096, n_experts=8, top_k=2, rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    subquadratic=True,   # SWA bounds the KV cache: long_500k eligible
)

REDUCED = ArchConfig(
    name="mixtral-8x22b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    head_dim=16, pattern=("swa",), ff_pattern=("moe",),
    window=32, n_experts=4, top_k=2, attn_chunk=32, subquadratic=True,
    moe_capacity_factor=4.0,
)
