"""The gradient-determinism probe (``repro_torch.launch.grad_determinism``)
on the CPU at a small width: it runs its three settings in fresh processes
and, since the CPU's sums run in a fixed order, finds every gradient equal
between a process's two calls and between two processes."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_probe_finds_the_cpu_gradients_reproducible():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.grad_determinism", "--device", "cpu",
         "--channels", "4", "--capacity", "48", "--max-atoms", "24", "--n-graphs", "16",
         "--timeout", "120"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary == {"default": [0, 0], "deterministic": [0, 0],
                       "deterministic_one_thread": [0, 0]}
