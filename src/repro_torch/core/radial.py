"""Radial embedding: Bessel basis x polynomial cutoff + radial MLP.

Port of the JAX package's ``core/radial.py``: 8 Bessel functions, the p=6
polynomial cutoff envelope, and a SiLU MLP mapping the radial embedding to
per-path, per-channel tensor-product weights.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def bessel_basis(r: torch.Tensor, r_max: float, num: int = 8) -> torch.Tensor:
    """sqrt(2/c) * sin(n pi r / c) / r, n = 1..num.  r: [...]. -> [..., num]."""
    n = torch.arange(1, num + 1, dtype=r.dtype, device=r.device)
    x = torch.where(r > 1e-9, r, torch.full_like(r, 1e-9))[..., None]
    return math.sqrt(2.0 / r_max) * torch.sin(n * math.pi * x / r_max) / x


def polynomial_cutoff(r: torch.Tensor, r_max: float, p: int = 6) -> torch.Tensor:
    """Smooth envelope, 1 at r=0, 0 with p continuous derivatives at r_max."""
    x = r / r_max
    out = (
        1.0
        - (p + 1.0) * (p + 2.0) / 2.0 * x**p
        + p * (p + 2.0) * x ** (p + 1)
        - p * (p + 1.0) / 2.0 * x ** (p + 2)
    )
    return out * (x < 1.0).to(out.dtype)


def init_mlp(generator: torch.Generator, sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    params = {}
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn((din, dout), generator=generator) / math.sqrt(din)
        params[f"b{i}"] = torch.zeros((dout,))
    return params


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Linear layers with SiLU between them."""
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.silu(x)
    return x


def radial_embedding(
    lengths: torch.Tensor, r_max: float, num_bessel: int = 8, p: int = 6
) -> torch.Tensor:
    """[E] -> [E, num_bessel]; envelope applied (edges beyond r_max vanish)."""
    return bessel_basis(lengths, r_max, num_bessel) * polynomial_cutoff(
        lengths, r_max, p
    )[..., None]
