"""The card's peak rates and three-term roofline, the per-kernel cost cells
the autotuner ranks with, the LM and MACE cells, and the dispatcher-level
counts of collectives and FLOPs that stand in for the JAX package's HLO
parser (port of the JAX package's ``roofline/``)."""
from .analysis import HW, RECOMMENDATION, roofline_terms  # noqa: F401
from .analytic import kernel_cell_cost  # noqa: F401
from .analytic import lm_cell_cost, mace_cell_cost  # noqa: F401
