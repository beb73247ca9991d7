"""Qwen3-14B [dense]: GQA kv=8, qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab=151936, head_dim=128,
    pattern=("attn",), ff_pattern=("mlp",),
    qk_norm=True, rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    subquadratic=False,
)

REDUCED = ArchConfig(
    name="qwen3-14b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    head_dim=16, pattern=("attn",), ff_pattern=("mlp",), qk_norm=True,
    attn_chunk=64,
)
