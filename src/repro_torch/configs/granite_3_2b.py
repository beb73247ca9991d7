"""Granite-3.0-2B [dense]: GQA kv=8.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=49155, head_dim=64,
    pattern=("attn",), ff_pattern=("mlp",),
    compute_dtype=torch.bfloat16,
    subquadratic=False,
)

REDUCED = ArchConfig(
    name="granite-3-2b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, pattern=("attn",), ff_pattern=("mlp",), attn_chunk=64,
)
