"""MACE-MP-0 large on the port (``configs/mace_mp0_large.py``): l = 2 hidden
features, so the symmetric contraction's spec ``SymConSpec(0-3, 0-2, 3)``
(7,101 CG entries, 9 output rows) and a 17-path layer-1 tensor product.
On the CPU: the second order's plain version at that spec against
autograd's double VJP of ``symcon_plain``, and the launcher's ``--config``
training the reduced model.  The kernels' checks at this spec are on the
card: ``chip_smoke.py`` phase 1 (the ptxas report) and phase 14 (at 3,072
atoms, against the plain versions: ``symcon_fwd``/``symcon_bwd``, layer 1's
``tp_scatter_fwd``/``tp_gather_bwd`` and ``symcon_dbl``), and the
``mp0_large`` / ``l2`` cases of ``test_torch_cuda.py``; the header and the
host build of the second-order source are ``test_torch_symcon_tables.py``'s
``mp0_large`` cases; the model against the benchmark's reference is
``perfbench/tests/test_perfbench_reference_l2.py``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.mace_mp0_large import CONFIG
from repro_torch.kernels.symmetric_contraction import kernel as sck

REPO = Path(__file__).resolve().parents[1]
SPEC = CONFIG.symcon_spec()


def test_the_configuration_is_the_published_one():
    assert get_config("mace_mp0_large") is CONFIG
    assert get_reduced("mace_mp0_large").symcon_spec() == SPEC
    assert (CONFIG.channels, CONFIG.hidden_ls, CONFIG.a_ls, CONFIG.correlation,
            CONFIG.n_interactions, CONFIG.r_max) == (128, (0, 1, 2), (0, 1, 2, 3), 3, 2, 6.0)
    groups, p_total = sck._group_entries(SPEC, sck.build_symcon_tables(SPEC))
    assert (sum(n for *_, n, _ in groups), p_total, SPEC.out_spec.dim) == (7101, 49, 9)
    assert len(CONFIG.tp_spec_at(1).paths) == 17


def test_symcon_dbl_plain_matches_the_double_vjp_of_symcon_plain():
    """The second order's explicit product rule at the large spec (the plain
    version the card's ``symcon_dbl`` is held to) against autograd's double
    VJP of ``symcon_plain``, with cotangents of (dA, dW)."""
    rng = np.random.default_rng(27)
    N, k = 2, 3
    shapes = {"A": (N, SPEC.in_spec.dim, k), "W": (N, sck.p_total_of(SPEC), k),
              "G": (N, SPEC.out_spec.dim, k)}
    x = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for n, s in shapes.items()}
    cA, cW = (torch.from_numpy(rng.standard_normal(shapes[n], dtype=np.float32))
              for n in ("A", "W"))
    a, w, g = (x[n].clone().requires_grad_(True) for n in ("A", "W", "G"))
    dA, dW = torch.autograd.grad(sck.symcon_plain(a, w, SPEC), (a, w), g, create_graph=True)
    want = torch.autograd.grad((dA, dW), (a, w, g), (cA, cW))
    got = sck.symcon_dbl_plain(x["A"], x["W"], x["G"], cA, cW, SPEC)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=2e-5, atol=2e-5)


def test_the_launcher_trains_the_reduced_large_model(tmp_path):
    """``launch.train --config mace_mp0_large --reduced`` takes two steps on
    the CPU at the configuration's 6 A cutoff."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--config", "mace_mp0_large",
         "--reduced", "--device", "cpu", "--steps", "2"], cwd=tmp_path, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(ln.split("loss ")[1]) for ln in proc.stdout.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps, engine sequential" in proc.stdout
