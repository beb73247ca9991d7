"""MusicGen-large [audio]: decoder-only LM over EnCodec tokens (frontend
STUB: token stream is precomputed).  [arXiv:2306.05284; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=2048,
    pattern=("attn",), ff_pattern=("mlp",),
    compute_dtype=torch.bfloat16,
    subquadratic=False,
)

REDUCED = ArchConfig(
    name="musicgen-large-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    pattern=("attn",), ff_pattern=("mlp",), attn_chunk=64,
)
