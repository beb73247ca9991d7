"""Reduced-precision compute contract shared by the CUDA kernels.

Port of the JAX package's ``kernels/precision.py``.  The mixed-precision
kernel variants (``cuda_bf16`` / ``cuda_fp8`` in the registry) compute on
*rounded* operands while keeping every accumulation in fp32:

* **Operands** (A and W of the symmetric contraction; Y, h, R and the
  incoming cotangent G of the interaction kernels) are rounded to the
  compute type as they are loaded (bf16 for ``"bf16"``, e4m3 fp8 for
  ``"fp8"``) and widened back to fp32.  They are still stored and read as
  fp32, so a variant moves the same bytes as the fp32 kernel.
* **Accumulation** stays fp32.
* The interaction forward also rounds each edge's formed message before it
  is summed into its receiver's row, as the reference's scatter matmul takes
  rounded messages.

:func:`round_to` is the plain version of the kernels' ``round_op``
(``csrc/round_op.cuh``) and follows the reference's rounding bit for bit,
which is ``ml_dtypes``'s: round to nearest even, subnormals kept, every NaN
becomes the quiet NaN ``0x7fc00000`` with the input's sign, and in fp8 every
magnitude above 464 (the midpoint between e4m3's largest value 448 and the
next step, 480, which e4m3fn spends on NaN) and every infinity becomes NaN
too.  PyTorch's own casts differ there: ``.to(torch.float8_e4m3fn)``
saturates to +-448, and ``.to(torch.bfloat16)`` turns a NaN into
``0xffff0000``.
"""
from __future__ import annotations

import torch

# every precision the kernels understand; "fp32" is the identity
PRECISIONS = ("fp32", "bf16", "fp8")

_COMPUTE_DTYPES = {
    "fp32": None,
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}

# magnitudes above this round to NaN in e4m3fn (464 itself ties to 448)
FP8_NAN_ABOVE = 464.0


def check_precision(precision: str) -> str:
    """Validate a precision name (returns it; raises ``ValueError`` else)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    return precision


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Round ``x`` to the compute type of ``precision``, widened back to
    ``x.dtype``: the operand-load rounding of the mixed-precision contract.
    ``"fp32"`` is the identity (no copy)."""
    dt = _COMPUTE_DTYPES[check_precision(precision)]
    if dt is None:
        return x
    y = x.to(dt).to(x.dtype)
    if precision == "fp8":
        to_nan = ~(x.abs() <= FP8_NAN_ABOVE)  # NaN, +-inf and beyond 464
    else:
        to_nan = torch.isnan(x)
    nan = torch.copysign(torch.full_like(x, float("nan")), x)
    return torch.where(to_nan, nan, y)
