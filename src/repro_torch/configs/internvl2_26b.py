"""InternVL2-26B [vlm]: InternViT frontend (STUB: precomputed patch embeddings
as prefix) + InternLM2-20B backbone.  [arXiv:2404.16821; hf]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, head_dim=128,
    pattern=("attn",), ff_pattern=("mlp",),
    n_prefix_embeds=256,       # ViT patch embeddings injected as prefix
    rope_theta=1e6,
    compute_dtype=torch.bfloat16,
    subquadratic=False,        # pure full attention: long_500k skipped
)

REDUCED = ArchConfig(
    name="internvl2-26b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16,
    pattern=("attn",), ff_pattern=("mlp",),
    n_prefix_embeds=8, attn_chunk=64,
)
