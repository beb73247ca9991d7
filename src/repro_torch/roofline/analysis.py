"""The card's peak rates: the constants every bound of the port reads
(``chip_smoke.py``'s ``bound_ms``, the autotuner's
``ROOFLINE_PEAKS["gpu"]``).

Port of the JAX package's ``roofline/analysis.py`` hardware constants for
the NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W
power limit).  A card set below 700 W runs slower under load, so a share
of these peaks is stated beside the card's power limit.  Not ported: the
JAX three-term ``roofline_terms`` (no caller in the port yet).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops_fp32: float = 67e12       # outside the tensor cores
    hbm_bw: float = 3.35e12              # bytes/s of the 80 GB HBM3
