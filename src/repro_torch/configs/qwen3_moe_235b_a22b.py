"""Qwen3-235B-A22B [moe]: 128 experts top-8, qk-norm, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128,
    pattern=("attn",), ff_pattern=("moe",),
    qk_norm=True, n_experts=128, top_k=8, rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    subquadratic=False,
)

REDUCED = ArchConfig(
    name="qwen3-moe-235b-a22b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
    head_dim=16, pattern=("attn",), ff_pattern=("moe",),
    qk_norm=True, n_experts=8, top_k=2, attn_chunk=64,
    moe_capacity_factor=4.0,
)
