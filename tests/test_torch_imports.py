"""Guards of the port: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor anything of the JAX package ``repro``, and ``chip_smoke.py``
refuses to report a result without a CUDA card or outside the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_FORBIDDEN_CHECK = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
    "print('FORBIDDEN', bad)\n"
    "sys.exit(1 if bad else 0)\n"
)


def _run(code, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_modules_import_no_jax_and_no_repro():
    mods = ["repro_torch", "repro_torch.serve", "repro_torch.kernels.registry",
            "repro_torch.kernels.cuda_lib",
            "repro_torch.kernels.symmetric_contraction.ops",
            "repro_torch.kernels.channelwise_tp.ops", "repro_torch.core.mace",
            "repro_torch.bridge", "repro_torch.configs.mace_cfm",
            "repro_torch.data", "repro_torch.data.sampler", "repro_torch.data.prefetch",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.train.engine",
            "repro_torch.train.train_loop", "repro_torch.train.compression",
            "repro_torch.launch.mesh", "repro_torch.launch.multihost",
            "repro_torch.launch.train", "repro_torch.launch.pack_and_balance",
            "repro_torch.launch.bench_distribution", "repro_torch.launch.train_mace_cfm",
            "repro_torch.launch.grad_determinism", "repro_torch.launch.serve_mace",
            "repro_torch.resilience", "repro_torch.resilience.faults",
            "repro_torch.resilience.heartbeat", "repro_torch.resilience.supervisor",
            "repro_torch.kernels.autotune", "repro_torch.kernels.bench",
            "repro_torch.launch.bench_kernels",
            "repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.roofline.analytic", "repro_torch.configs",
            *(f"repro_torch.configs.{a}" for a in (
                "internvl2_26b", "musicgen_large", "qwen3_14b", "qwen2_5_3b", "granite_3_2b",
                "gemma3_4b", "xlstm_125m", "mixtral_8x22b", "qwen3_moe_235b_a22b",
                "jamba_v0_1_52b")),
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.xlstm",
            "repro_torch.models.model", "repro_torch.data.sequence_pack",
            "repro_torch.launch.lm_train_step", "repro_torch.launch.lm_pretrain",
            "repro_torch.launch.serve", "repro_torch.serve.lm_engine",
            "repro_torch.launch.shapes", "repro_torch.launch.sharding",
            "repro_torch.launch.dryrun", "repro_torch.roofline.collectives",
            "repro_torch.kernels.symmetric_contraction.ref",
            "repro_torch.kernels.channelwise_tp.ref"]
    proc = _run("".join(f"import {m}\n" for m in mods) + _FORBIDDEN_CHECK)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax_and_no_repro():
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\nimport chip_smoke\n"
            + _FORBIDDEN_CHECK)
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"ok"' not in proc.stdout  # importing it runs nothing


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"]
)
def test_source_has_no_jax_or_repro_import(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, n)


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    code = "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 3)"
    if _run(code).returncode == 0:
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory it cannot find the port and fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
