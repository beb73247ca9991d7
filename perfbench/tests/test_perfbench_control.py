"""The control of each cell on the card: the reference computed in TF32,
put in the program's place, comes out not correct under the cell's limits
(each cell at its own widths and bin size, on a smaller pool of graphs).
Needs a CUDA card (marked ``gpu``); skips without one."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import calibrate, harness, run

CELLS = ["mace_cfm.train_bins3072", "mace_mp0_medium.train_bins3072",
         "mace_cfm.serve_closed64"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    harness.prepare_environment()
    w = harness.workload(harness.benchmark(), cell)
    config = harness.data_file("configs", w["config"])
    traffic = dict(harness.data_file("traffic", w["traffic"]), n_graphs=300, pool=300)
    mix = harness.module("mixes", traffic["mix"])
    dev = harness.Device(torch.device("cuda", 0))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ctx = run.Context(seed, 1.0, False, config, traffic, dev, time.perf_counter())
        correct, checks = harness.judge(calibrate.control(ctx, mix, seed),
                                        {k: v for k, v in harness.limits_of(cell).items()
                                         if k not in ("bad_bins", "lost")})
        assert not correct, checks
