"""The card's peak rates and the three-term roofline: the constants every
bound of the port reads (``chip_smoke.py``'s ``bound_ms``, the autotuner's
``ROOFLINE_PEAKS["gpu"]``, the LM train step's model-FLOP share, the dry
run's ``roofline``).

Port of the JAX package's ``roofline/analysis.py`` for the NVIDIA H100 SXM
(NVIDIA's data sheet, dense rates, at the full 700 W power limit).  A card
set below 700 W runs slower under load, so a share of these peaks is stated
beside the card's power limit.

    compute_s    = FLOPs / (chips x peak)        peak: HW's bf16 or fp32
    memory_s     = HBM bytes / (chips x hbm_bw)
    collective_s = per-device collective bytes / link_bw

FLOPs and HBM bytes come from the analytic model (``analytic.py``), the
collective bytes from the dry run's count (``collectives.py``).  The
dominant term is the bottleneck; ``roofline_fraction`` is ``compute_s /
max(terms)``, how close the cell is to compute-bound peak.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops_bf16: float = 989e12      # dense, on the tensor cores
    peak_flops_fp32: float = 67e12       # outside the tensor cores
    hbm_bw: float = 3.35e12              # bytes/s of the 80 GB HBM3
    # NVLink 4: 18 links, 900 GB/s per GPU in both directions together, so
    # 450 GB/s each way (the data sheet's figure); the role of the JAX
    # model's per-link, per-direction ``ici_bw``
    link_bw: float = 450e9


def roofline_terms(
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes_per_device: float,
    chips: int,
    dtype: str = "bf16",
    hw: HW = HW(),
) -> Dict[str, float]:
    peak = hw.peak_flops_bf16 if dtype == "bf16" else hw.peak_flops_fp32
    compute_s = flops / (chips * peak)
    memory_s = hbm_bytes / (chips * hw.hbm_bw)
    collective_s = collective_bytes_per_device / hw.link_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    step = max(terms.values())
    return {
        **terms,
        "dominant": dom,
        "step_time_lb_s": step,
        "roofline_fraction": compute_s / step if step > 0 else 0.0,
        "chips": chips,
    }


RECOMMENDATION = {
    "compute_s": "compute-bound: good — push MFU via larger per-chip tiles "
                 "or reduced remat recompute",
    "memory_s": "HBM-bound: raise arithmetic intensity (bigger microbatch "
                "per chip, fuse param casts, cut optimizer traffic)",
    "collective_s": "collective-bound: reshard to cut cross-chip bytes "
                    "(more DP/less TP, expert-parallel alignment, overlap "
                    "collectives with compute)",
}
