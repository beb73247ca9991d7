"""Real spherical harmonics in torch, evaluated as fitted polynomials.

Port of the JAX package's ``core/spherical.py``.  The coefficient tables come
from :func:`repro_torch.core.cg.real_sh_polys`, the same complex->real
construction as the CG tensors, so model equivariance holds by construction.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .cg import monomial_exponents, real_sh_polys


def spherical_harmonics(
    lmax: int, vectors: torch.Tensor, eps: float = 1e-9
) -> torch.Tensor:
    """Evaluate real SH for l = 0..lmax of the directions of ``vectors``.

    Args:
      lmax: maximum order.
      vectors: [..., 3], any length; they are safely normalised (padding
        rows of zeros are fine — they evaluate to garbage that callers mask
        out).

    Returns:
      [..., sum(2l+1)] concatenated l-blocks, ascending l.
    """
    # clamp BEFORE the sqrt: d(sqrt)/dx at 0 is inf, and padded edges have
    # exactly-zero vectors — grad must flow to the clamp, not the sqrt.
    n2 = torch.sum(vectors * vectors, dim=-1, keepdim=True)
    v = vectors / torch.sqrt(torch.clamp(n2, min=eps * eps))
    x, y, z = v[..., 0], v[..., 1], v[..., 2]

    blocks = []
    for l in range(lmax + 1):
        coeffs = _sh_coeffs(l, vectors.dtype, vectors.device)
        monos = torch.stack(
            [
                _int_pow(x, a) * _int_pow(y, b) * _int_pow(z, c)
                for (a, b, c) in monomial_exponents(l)
            ],
            dim=-1,
        )  # [..., n_mono]
        blocks.append(monos @ coeffs.T)  # [..., 2l+1]
    return torch.cat(blocks, dim=-1)


@functools.lru_cache(maxsize=None)
def _sh_coeffs(l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The order-``l`` coefficient table on ``device``, made once per (l,
    dtype, device): a copy from the host at every call would make the stream
    wait on it, and a CUDA graph cannot capture it."""
    return torch.as_tensor(np.asarray(real_sh_polys(l)), dtype=dtype, device=device)


def _int_pow(t: torch.Tensor, p: int) -> torch.Tensor:
    if p == 0:
        return torch.ones_like(t)
    out = t
    for _ in range(p - 1):
        out = out * t
    return out
