"""Gemma3-4B [dense]: 5:1 local:global attention, 128k context, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"),  # 5 local : 1 global
    ff_pattern=("mlp",),
    window=1024, rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    # mostly-local: global layers are O(1) per decode step with a full cache;
    # eligible for long_500k (6 global caches of 512k, sharded)
    subquadratic=True,
)

REDUCED = ArchConfig(
    name="gemma3-4b-reduced",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16,
    pattern=("swa", "swa", "swa", "swa", "swa", "attn"), ff_pattern=("mlp",),
    window=32, attn_chunk=32, subquadratic=True,
)
