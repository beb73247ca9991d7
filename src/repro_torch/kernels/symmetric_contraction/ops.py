"""Public wrapper for the symmetric-contraction kernels (port of the JAX
package's ``kernels/symmetric_contraction/ops.py::symcon_pallas``).

Handles layout (the model uses [N, k, d]; the kernels want k minor), atom
padding to ``block_n``, and the species->weight gather, all in plain torch.
The kernel-layout core ``(A_t, W_t) -> B_t`` is a ``torch.autograd.Function``
whose backward is the dedicated backward kernel: the saved tensors are
exactly the kernel's inputs ``(A_t, W_t)``, and ``dW_t`` flows back through
the plain-torch gather into the per-``(L, nu)`` weights with no custom code.

Second order (forces inside the training loss make every step a
grad-of-grad): the backward kernel is itself an ``autograd.Function``
(:class:`_SymconBwdOp`) whose derivative is a third kernel,
``kernel.symcon_dbl`` (its plain version ``symcon_dbl_plain`` on the CPU):
the VJP of the backward's map, which the JAX package's ``_symcon_bwd_op``
takes as the double VJP of its XLA twin ``symcon_xla_raw``; the tests hold
it to autograd's double VJP of ``kernel.symcon_plain``, that twin's port.  A
third order raises.

Precision: ``symcon_cuda(..., precision=)`` selects the kernels' operand
rounding (``kernels/precision.py``) for the forward and the first-order
backward; the second order stays fp32 at every setting, as the JAX
package's twins stay fp32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.symmetric_contraction import SymConSpec
from repro_torch.kernels import refuse_third_order
from repro_torch.kernels.precision import check_precision

from .kernel import gather_weights, symcon_bwd, symcon_dbl, symcon_fwd


def _count_spec(sp: tracing.Span, rows: int, k: int, spec: SymConSpec) -> None:
    """The counters of a ``model.symcon`` / ``model.symcon_twin`` span: the
    atoms launched (padded), the channels and the spec."""
    sp.count("rows", rows)
    sp.count("channels", k)
    sp.count("hidden_lmax", spec.out_spec.lmax)
    sp.count("a_lmax", spec.in_spec.lmax)
    sp.count("correlation", spec.nu_max)


class _SymconBwdOp(torch.autograd.Function):
    """``(A_t, W_t, G_t) -> (dA_t, dW_t)``: the backward kernel, whose own
    derivative is the second-order kernel ``symcon_dbl``."""

    @staticmethod
    def forward(ctx, A_t, W_t, G_t, spec, precision="fp32"):
        ctx.spec = spec
        ctx.save_for_backward(A_t, W_t, G_t)
        return symcon_bwd(A_t, W_t, G_t, spec, precision)

    @staticmethod
    def backward(ctx, ddA, ddW):
        refuse_third_order("symcon backward")
        with tracing.span("model.symcon_twin", tracing.handed_off()) as sp:
            if sp is not None:
                _count_spec(sp, ddA.shape[0], ddA.shape[2], ctx.spec)
            da, dw, dg = symcon_dbl(*ctx.saved_tensors, ddA.contiguous(),
                                    ddW.contiguous(), ctx.spec)
        return da, dw, dg, None, None


class _SymconOp(torch.autograd.Function):
    """``(A_t [N, d_in, k], W_t [N, P, k]) -> B_t [N, d_out, k]``."""

    @staticmethod
    def forward(ctx, A_t, W_t, spec, precision):
        ctx.spec, ctx.precision = spec, precision
        ctx.save_for_backward(A_t, W_t)
        return symcon_fwd(A_t, W_t, spec, precision)

    @staticmethod
    def backward(ctx, g):
        A_t, W_t = ctx.saved_tensors
        dA, dW = _SymconBwdOp.apply(A_t, W_t, g.contiguous(), ctx.spec, ctx.precision)
        return dA, dW, None, None


def symcon_cuda(
    A: torch.Tensor,                 # [N, k, d_in]
    species: torch.Tensor,           # [N]
    weights: Dict[str, torch.Tensor],
    spec: SymConSpec,
    *,
    block_n: int = 32,
    precision: str = "fp32",
) -> torch.Tensor:
    """Registered ``symcon/cuda`` impl (``cuda_bf16`` / ``cuda_fp8`` at a
    reduced ``precision``): B [N, k, d_out]."""
    check_precision(precision)
    N, k = A.shape[0], A.shape[1]
    pad = (-N) % block_n
    with tracing.span("model.symcon") as sp:
        if sp is not None:
            _count_spec(sp, N + pad, k, spec)
        Wg = gather_weights(weights, species, spec)      # [N, k, P]
        A_t = A.transpose(1, 2)                          # [N, d_in, k]
        W_t = Wg.transpose(1, 2)                         # [N, P, k]
        if pad:
            A_t = F.pad(A_t, (0, 0, 0, 0, 0, pad))
            W_t = F.pad(W_t, (0, 0, 0, 0, 0, pad))
        B_t = _SymconOp.apply(A_t.contiguous(), W_t.contiguous(), spec, precision)
    return B_t[:N].transpose(1, 2)                   # [N, k, d_out]
