"""Qwen2.5-3B [dense]: GQA kv=2, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, head_dim=128,
    pattern=("attn",), ff_pattern=("mlp",),
    qkv_bias=True, rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    subquadratic=False,
)

REDUCED = ArchConfig(
    name="qwen2.5-3b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    head_dim=16, pattern=("attn",), ff_pattern=("mlp",), qkv_bias=True,
    attn_chunk=64,
)
