"""xLSTM-125M [ssm]: alternating mLSTM (matrix memory) + sLSTM (scalar
memory) blocks, no external FFN (d_ff=0).  [arXiv:2405.04517; unverified]"""
import torch

from repro_torch.models.model import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304,
    pattern=("mlstm", "slstm"), ff_pattern=("none",),
    compute_dtype=torch.bfloat16,
    subquadratic=True,
)

REDUCED = ArchConfig(
    name="xlstm-125m-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
    pattern=("mlstm", "slstm"), ff_pattern=("none",), subquadratic=True,
)
