"""The card's peak rates and the per-kernel cost cells the autotuner ranks
with (port of the JAX package's ``roofline/``, MACE kernels only)."""
from .analysis import HW  # noqa: F401
from .analytic import kernel_cell_cost  # noqa: F401
