"""The card's peak rates, the per-kernel cost cells the autotuner ranks
with, and the LM cells (port of the JAX package's ``roofline/``; its HLO
parser ``hlo.py`` reads XLA programs and has no counterpart here)."""
from .analysis import HW  # noqa: F401
from .analytic import kernel_cell_cost  # noqa: F401
from .analytic import lm_cell_cost  # noqa: F401
