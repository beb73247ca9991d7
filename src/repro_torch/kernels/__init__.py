"""Kernel registry, the CUDA build, the kernel wrappers and the autotuner of
the port.

``autotune`` resolves ``"auto"`` impls from ``tuning_table.json``, built
from the timings in ``bench_kernels.json`` (both beside this file).
Regenerating them on a machine with the card, then checking the table
on any machine::

    python -m repro_torch.kernels.autotune --tune 60 --write --platform gpu
    PYTHONPATH=src python -m repro_torch.kernels.autotune --check --platform gpu

(``--trajectory`` and ``--table`` write elsewhere than the committed
files).  CPU rows come from ``python -m repro_torch.launch.bench_kernels
--grad --quick --device cpu``; every other CPU bucket is roofline-ranked.
"""
import torch


def refuse_third_order(op: str) -> None:
    """A kernel op's second-order rule (a kernel) builds no graph: refuse a
    backward that is asked to build one (a third derivative)."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{op}: only first and second derivatives are implemented "
            "(the second-order rule does not build a graph)"
        )
