"""Probe: are one bin's parameter gradients on the card reproducible?

    PYTHONPATH=src python -m repro_torch.launch.grad_determinism

Builds the training run of ``chip_smoke.py``'s data-parallel phase at two
logical ranks (the paper's widths, ``SyntheticCFMDataset(2000, seed=0,
max_atoms=256)``, the balanced sampler at capacity 3,072, random weights
from seed 0) and, in two fresh processes per setting (run at once), takes
the loss gradients of the first step's bin 0 twice.  Per setting it prints
the gradient elements where a process's first call differs from its second,
and where the two processes' second calls differ.  Settings:

* ``default``;
* ``deterministic``: ``torch.use_deterministic_algorithms(True)`` (a sorted
  ``index_add_``), with cuBLAS's fixed workspace;
* ``deterministic_one_thread``: that, and the backward on the calling
  thread (``torch.autograd.set_multithreading_enabled(False)``) instead of
  autograd's worker thread.

``--device cpu`` with the size flags runs it small on the CPU.  The last
line is a JSON object: ``{setting: [first vs second, process vs process]}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SETTINGS = ("default", "deterministic", "deterministic_one_thread")


def _two_calls(args, setting: str, out: str) -> None:
    """One process: bin 0's flat gradients, twice, saved ``[2, P]`` to
    ``out``."""
    import torch

    from repro_torch.configs.mace_cfm import CONFIG
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if setting != "default":
        torch.use_deterministic_algorithms(True)
    if setting == "deterministic_one_thread":
        torch.autograd.set_multithreading_enabled(False)
    tcfg = TrainerConfig(capacity=args.capacity, edge_factor=48,
                         max_graphs=max(16, args.capacity // 8), n_ranks=2)
    dataset = SyntheticCFMDataset(args.n_graphs, seed=0, max_atoms=args.max_atoms)
    tr = Trainer(dataclasses.replace(CONFIG, channels=args.channels), tcfg, dataset,
                 seed=0, device=args.device)
    rank_bins = next(tr.sampler.step_iter(tr.sampler_state))
    host, _ = tr.engine.collate([[tr.dataset.get(i) for i in b] for b in rank_bins],
                                tr.bin_shape)
    batch = tr.engine.to_device(host)[0]
    calls = []
    for _ in range(2):
        grads, _ = tr.engine.grads(tr.params, batch)
        calls.append(torch.cat([g.reshape(-1) for g in grads.values()]).cpu().numpy())
    np.save(out, np.stack(calls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--capacity", type=int, default=3072)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--n-graphs", type=int, default=2000)
    ap.add_argument("--max-atoms", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds each pair of processes may take")
    ap.add_argument("--child", nargs=2, metavar=("SETTING", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _two_calls(args, *args.child)
        return 0

    src = str(Path(__file__).resolve().parents[2])
    flags = [f"--device={args.device}", f"--capacity={args.capacity}",
             f"--channels={args.channels}", f"--n-graphs={args.n_graphs}",
             f"--max-atoms={args.max_atoms}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for setting in SETTINGS:
            # cuBLAS is deterministic under torch's deterministic mode only
            # with a fixed workspace
            env_s = dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8") if setting != "default" else env
            outs = [os.path.join(tmp, f"{setting}.{i}.npy") for i in range(2)]
            procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.grad_determinism",
                                       *flags, "--child", setting, out], env=env_s)
                     for out in outs]
            codes = [p.wait(timeout=args.timeout) for p in procs]
            if codes != [0, 0]:
                raise RuntimeError(f"{setting}: processes exited {codes}")
            (a, b) = (np.load(out) for out in outs)
            first = int((a[0] != a[1]).sum())
            across = int((a[1] != b[1]).sum())
            summary[setting] = [first, across]
            print(f"{setting}: {first} of {a.shape[1]} gradient elements differ between a "
                  f"process's first call and its second; {across} between two processes' "
                  f"second calls", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
