"""The port's serving entry point, ``python -m repro_torch.launch.serve_mace``,
on the CPU at the JAX example's widths (8 channels): the skewed mix served
whole through a worker fault, armed by ``--kill-worker`` or by
``REPRO_FAULT_PLAN``, with one drain-and-rebuild and a census of 0 per
bucket (the CPU engine captures no graph)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
DRILLS = {
    "kill_worker": (["--kill-worker"], {}),
    "fault_plan": ([], {"REPRO_FAULT_PLAN": json.dumps({"serve_worker_fault": {}})}),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_serve_mace_on_the_cpu_survives_a_worker_fault(drill):
    flags, env = DRILLS[drill]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_mace", "--device", "cpu",
         "--requests", "24", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"), **env))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    summary = json.loads(next(ln for ln in lines if ln.startswith("summary "))[8:])
    assert summary["device"] == "cpu"
    assert summary["served"] == summary["requests"] == 24 and summary["failed"] == 0
    assert summary["rebuilds"] == 1
    assert summary["compile_census"] == {"n64_e3072_g8": 0, "n128_e6144_g16": 0}
    assert "injected fault" in proc.stderr


def test_serve_mace_refuses_auto_until_the_autotuner_is_ported():
    """With the autotuner ported, ``--interaction-impl auto`` (the default,
    as in the JAX example) resolves from the tuning table, prints the
    decision and serves every request."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_mace", "--device", "cpu",
         "--interaction-impl", "auto", "--requests", "12"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("autotune: "))
    assert line.startswith("autotune: interaction[") and ",cpu,fwd_bwd] -> " in line
    assert proc.stdout.rstrip().endswith("OK")
