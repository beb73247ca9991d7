"""Whole runs of each cell on the CPU at a small size, past the harness's
look for a card: sound runs come out ``correct``, and runs with the timed
path broken underneath come out not correct, once for each fault the cell
can have (a step that leaves its state unchanged; half of the batch left
out, the mean over the rest; an answer altered where it is produced)."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness, run

CPU = torch.device("cpu")
TINY_CONFIG = {"n_species": 10, "channels": 8, "sh_lmax": 2, "a_ls": [0, 1, 2],
               "avg_num_neighbors": 8.0}
TINY_TRAFFIC = {"n_graphs": 40, "capacity": 256, "max_graphs": 32, "max_atoms": 64,
                "reference_block_atoms": 128, "pool": 60, "clients": 8,
                "ladder": [64, 256], "warm_requests": 8, "checked_requests": 16,
                "profile_s": 0.3}
TRAIN = "mace_cfm.train_bins3072"
SERVE = "mace_cfm.serve_closed64"


def drive(cell, capsys, monkeypatch, fault=None, trace=0, seed=2**31 + 5, correlation=None):
    # other test files of this process may have loaded JAX: the look for it
    # is tested on its own below
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    config = dict(TINY_CONFIG, **({"correlation": correlation} if correlation else {}))
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                   "--trace", str(trace)], device=CPU, fault=fault,
                  overrides={"config": config, "traffic": TINY_TRAFFIC})
    assert rc == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell,correlation", [(TRAIN, None),
                                              ("mace_mp0_medium.train_bins3072", 2)])
def test_training_runs_are_correct(cell, correlation, capsys, monkeypatch):
    line = drive(cell, capsys, monkeypatch, trace=1, correlation=correlation)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"data_wait_ms.train", "edge_fill.train", "atom_fill.train",
            "mfu.train"} <= set(line["metrics"])


def test_a_step_that_leaves_its_state_unchanged_is_caught(capsys, monkeypatch):
    def frozen(trainer):
        step = trainer.engine.step

        def same(params, opt_state, ef, batches, i):
            return (params, opt_state) + step(params, opt_state, ef, batches, i)[2:]
        trainer.engine.step = same

    line = drive(TRAIN, capsys, monkeypatch, fault=frozen)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out_is_caught(capsys, monkeypatch):
    def halve(trainer):
        collate = trainer.engine.collate
        trainer.engine.collate = lambda mols, shape: collate(
            [m[: max(len(m) // 2, 1)] for m in mols], shape)

    line = drive(TRAIN, capsys, monkeypatch, fault=halve)
    assert not line["correct"]


def test_serving_run_is_correct_and_an_altered_answer_is_caught(capsys, monkeypatch):
    line = drive(SERVE, capsys, monkeypatch, trace=1)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and "bin_fill.serve" in line["metrics"]

    def alter(server):
        forward = server.engine.forward

        def wrong(batch, bucket):
            e, f = forward(batch, bucket)
            return e + 1.0, f
        server.engine.forward = wrong

    line = drive(SERVE, capsys, monkeypatch, fault=alter)
    assert not line["correct"]
    assert line["checks"]["energy_gap"]["value"] > line["checks"]["energy_gap"]["limit"]


def test_the_run_refuses_to_report_with_jax_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert "jaxlib" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_not", types.ModuleType("x"))
    assert "repro_torch_not" not in harness.forbidden_modules()


def test_without_a_card_the_command_fails_and_prints_nothing():
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", TRAIN,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
