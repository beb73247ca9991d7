"""Public wrapper for the symmetric-contraction kernels (port of the JAX
package's ``kernels/symmetric_contraction/ops.py::symcon_pallas``).

Handles layout (the model uses [N, k, d]; the kernels want k minor), atom
padding to ``block_n``, and the species->weight gather, all in plain torch.
The kernel-layout core ``(A_t, W_t) -> B_t`` is a ``torch.autograd.Function``
whose backward is the dedicated backward kernel: the saved tensors are
exactly the kernel's inputs ``(A_t, W_t)``, and ``dW_t`` flows back through
the plain-torch gather into the per-``(L, nu)`` weights with no custom code.

The backward is ``once_differentiable``: a grad-of-grad (forces inside a
training loss) raises until the training slice adds the second-order twin.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core.symmetric_contraction import SymConSpec

from .kernel import gather_weights, symcon_bwd, symcon_fwd


class _SymconOp(torch.autograd.Function):
    """``(A_t [N, d_in, k], W_t [N, P, k]) -> B_t [N, d_out, k]``."""

    @staticmethod
    def forward(ctx, A_t, W_t, spec):
        ctx.spec = spec
        ctx.save_for_backward(A_t, W_t)
        return symcon_fwd(A_t, W_t, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        A_t, W_t = ctx.saved_tensors
        dA, dW = symcon_bwd(A_t, W_t, g.contiguous(), ctx.spec)
        return dA, dW, None


def symcon_cuda(
    A: torch.Tensor,                 # [N, k, d_in]
    species: torch.Tensor,           # [N]
    weights: Dict[str, torch.Tensor],
    spec: SymConSpec,
    *,
    block_n: int = 32,
) -> torch.Tensor:
    """Registered ``symcon/cuda`` impl: B [N, k, d_out]."""
    N = A.shape[0]
    pad = (-N) % block_n
    Wg = gather_weights(weights, species, spec)      # [N, k, P]
    A_t = A.transpose(1, 2)                          # [N, d_in, k]
    W_t = Wg.transpose(1, 2)                         # [N, P, k]
    if pad:
        A_t = F.pad(A_t, (0, 0, 0, 0, 0, pad))
        W_t = F.pad(W_t, (0, 0, 0, 0, 0, pad))
    B_t = _SymconOp.apply(A_t.contiguous(), W_t.contiguous(), spec)
    return B_t[:N].transpose(1, 2)                   # [N, k, d_out]
