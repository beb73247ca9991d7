"""The LM serving engine on the card: one CUDA graph each for prefill and
decode, replayed against the same computation run eagerly on the card and
on the CPU.

Marked ``gpu``: it needs a CUDA device and skips without one
(``python -m pytest -m gpu tests/test_torch_lm_cuda.py`` on a GPU machine).
Imports no JAX.  Tolerance 2e-5 (tests/test_kernels.py), fp32 with TF32
off.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models.model import init_params
from repro_torch.serve.lm_engine import LMServeEngine

pytestmark = pytest.mark.gpu
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engines(dev, arch, batch, prompt_len):
    cfg = get_reduced(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    engines = [LMServeEngine(copy.deepcopy(model).to(d), cfg, batch, prompt_len, device=d)
               for d in (torch.device("cpu"), dev)]
    for eng in engines:
        eng.warmup()
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32))
    return engines, prompts


@pytest.mark.parametrize("arch", ["gemma3_4b", "jamba_v0_1_52b", "xlstm_125m"])
def test_replay_equals_eager_and_the_cpu_past_the_window(dev, arch):
    """Prefill of 40 tokens (past gemma3's window of 32: its local caches
    hold the last 32 in slot order) and 6 decode replays, each against the
    same call eagerly on the card and on the CPU."""
    (cpu_eng, eng), prompts = _engines(dev, arch, 2, 40)
    for i in range(7):
        step = ((lambda e, **kw: e.prefill(prompts.to(e.device), **kw)) if i == 0
                else (lambda e, **kw: e.decode(40 + i - 1, **kw)))
        want_tok, want = (t.cpu().clone() for t in step(cpu_eng))
        before = [eng.tok.clone()] + [t.clone() for s in eng.state for t in s.values()]
        tok, got = (t.cpu().clone() for t in step(eng))
        # rerun the same call eagerly from the same buffers
        for buf, saved in zip([eng.tok] + [t for s in eng.state for t in s.values()], before):
            buf.copy_(saved)
        eager_tok, eager = (t.cpu().clone() for t in step(eng, eager=True))
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(eager, got, **TOL)
        assert torch.equal(tok, want_tok) and torch.equal(eager_tok, tok)
    assert eng.compile_census() == {"prefill": 1, "decode": 1}
    eng.close()


def test_a_batch_of_another_shape_raises_and_captures_nothing(dev):
    (_, eng), prompts = _engines(dev, "granite_3_2b", 3, 16)
    eng.prefill(prompts.to(dev))
    with pytest.raises(ValueError, match="this engine serves"):
        eng.prefill(prompts[:2].to(dev))
    with pytest.raises(ValueError, match="this engine serves"):
        eng.prefill(torch.zeros((3, 17), dtype=torch.int32, device=dev))
    assert eng.compile_census() == {"prefill": 1, "decode": 1}
    eng.close()
    with pytest.raises(RuntimeError, match="no captured graph"):
        eng.decode(16)


def test_ddp_step_in_a_world_of_one_is_the_plain_step(dev, tmp_path):
    """``make_lm_train_step_ddp`` in an NCCL world of one (whose plain
    mean issues no collective) against ``make_lm_train_step`` on the same
    state and batch (REDUCED xlstm, fp32): the same loss, m and v within
    2e-4, the parameters within 2e-4 where Adam is well conditioned
    (sqrt(v_hat) 0 or above 100 eps)."""
    import torch.distributed as dist

    from repro_torch.launch.lm_train_step import (
        init_opt_state, make_lm_train_step, make_lm_train_step_ddp,
    )
    from repro_torch.launch.multihost import initialize_distributed

    cfg = get_reduced("xlstm_125m")
    model = init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32)).astype(np.int32)).to(dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    plain = copy.deepcopy(model)
    pm, pv = init_opt_state(plain)
    plain, pm, pv, ploss, _ = make_lm_train_step(cfg, lr=1e-3)(plain, pm, pv, batch, 0)
    initialize_distributed(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        m, v = init_opt_state(model)
        model, m, v, loss, _ = make_lm_train_step_ddp(cfg, lr=1e-3)(model, m, v, batch, 0)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(float(loss), float(ploss), rtol=1e-6)
    want = dict(plain.named_parameters())
    for n, p in model.named_parameters():
        torch.testing.assert_close(m[n], pm[n], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(v[n], pv[n], rtol=2e-4, atol=2e-4)
        held = (torch.sqrt(pv[n] / (1 - 0.999)) == 0) | (torch.sqrt(pv[n] / (1 - 0.999)) > 1e-6)
        torch.testing.assert_close(p.detach()[held], want[n].detach()[held], rtol=2e-4, atol=2e-4)
