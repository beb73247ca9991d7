"""Port parity, LM training and serving: ``make_lm_train_step`` for three
steps against the JAX step (micro-batches 1 and 2), sequence packing
(``pack_documents``, ``packing_stats``) and the LM cost model
(``lm_cell_cost``) against the JAX package's, and the entry points
``launch/lm_pretrain.py`` and ``launch/serve.py`` on the CPU (the serving
engine's census 0, its greedy tokens those of the plain prefill and decode
calls), all on the CPU.

Tolerance of the trajectories: 2e-4 (tests/test_backward.py), for losses,
Adam's moments and the parameters after every step (the parameters where
Adam is well conditioned; see ``test_three_train_steps_match_jax``).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.sequence_pack import pack_documents as jpack
from repro.data.sequence_pack import packing_stats as jstats
from repro.launch.lm_train_step import make_lm_train_step as jmake_step
from repro.launch.shapes import LM_SHAPES
from repro.models import model as jm
from repro.roofline.analytic import _avg_causal_kv as javg
from repro.roofline.analytic import lm_cell_cost as jcost
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.sequence_pack import pack_documents, packing_stats
from repro_torch.launch import lm_pretrain, serve
from repro_torch.launch.lm_train_step import init_opt_state, make_lm_train_step
from repro_torch.models import model as tm
from repro_torch.roofline import HW, lm_cell_cost
from repro_torch.roofline.analytic import _avg_causal_kv
from repro_torch.serve.lm_engine import LMServeEngine

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ADAM_EPS, ADAM_B2 = 1e-8, 0.999    # adamw's defaults, both packages
ADAM_HELD_EPS = 100                # chip_smoke.py's bound for a well-conditioned Adam


def _packed_batches(cfg, n, B=4, S=32, seed=0):
    """``n`` batches of packed documents, labels within each document."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 20, size=60)
    packed = pack_documents(lengths, S, B, lambda d, ln: np.random.default_rng(d).integers(
        1, cfg.vocab, size=ln))
    out = []
    for i in range(n):
        batch = lm_pretrain.packed_batch(packed, i, B, cfg, "cpu")
        out.append({k: v.numpy() for k, v in batch.items()})
    return out


def _tree(cfg, jtree):
    """A JAX parameter-shaped tree -> {port parameter name: tensor}."""
    return {n: p.detach() for n, p in
            tm.LM(cfg, lm_params_from_jax(jax.tree.map(np.asarray, jtree), cfg)).named_parameters()}


@pytest.mark.parametrize("micro_batches", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_2b", "xlstm_125m", "qwen3_moe_235b_a22b"])
def test_three_train_steps_match_jax(arch, micro_batches):
    """Three steps of the JAX trajectory, each also taken by the port from
    the JAX state before it (parameters, m, v): the loss, m and v after it
    everywhere, the parameters wherever Adam is well conditioned.  Near |g|
    = eps Adam turns float32 rounding into up to lr of an update
    (tests/test_torch_train.py::test_adam_update_amplifies_rounding_of_gradients_near_eps),
    so, as ``chip_smoke.py`` does, a parameter is held where the JAX
    denominator sqrt(v_hat) is 0 or above ``ADAM_HELD_EPS`` eps; the others
    (under 1%) must stay within 2 lr.  Beside it the port's own free
    three-step trajectory: its losses are the JAX ones."""
    lr = 1e-3
    jc, tc = jget_reduced(arch), get_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    jm_ = jv = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    jstep = jax.jit(jmake_step(jc, lr=lr, micro_batches=micro_batches))
    step = make_lm_train_step(tc, lr=lr, micro_batches=micro_batches)
    free = tm.LM(tc, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc))
    fm, fv = init_opt_state(free)
    n_held = n_all = 0
    for i, batch in enumerate(_packed_batches(tc, 3)):
        tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
        model = tm.LM(tc, lm_params_from_jax(jax.tree.map(np.asarray, jp), tc))
        m, v = _tree(tc, jm_), _tree(tc, jv)
        jp, jm_, jv, jloss = jstep(jp, jm_, jv, batch, jnp.asarray(i))
        model, m, v, loss, gnorm = step(model, m, v, tbatch, i)
        np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
        assert np.isfinite(float(gnorm)) and float(gnorm) > 0
        for name, got, want in (("m", m, _tree(tc, jm_)), ("v", v, _tree(tc, jv))):
            for n, w in want.items():
                np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                           err_msg=f"step {i} {name} {n}", **GRAD_TOL)
        want, jvs = _tree(tc, jp), _tree(tc, jv)
        for n, p in model.named_parameters():
            den = torch.sqrt(jvs[n] / (1 - ADAM_B2 ** (i + 1)))
            h = (den == 0) | (den > ADAM_HELD_EPS * ADAM_EPS)
            got, w = p.detach(), want[n]
            np.testing.assert_allclose(got[h].numpy(), w[h].numpy(), err_msg=f"step {i} {n}",
                                       **GRAD_TOL)
            assert float((got - w).abs().max()) <= 2 * lr + 2e-4, (i, n)
            n_held, n_all = n_held + int(h.sum()), n_all + h.numel()
        free, fm, fv, floss, _ = step(free, fm, fv, tbatch, i)
        np.testing.assert_allclose(float(floss), float(jloss), **GRAD_TOL)
    assert n_all - n_held < 0.01 * n_all, (n_held, n_all)


def test_micro_batches_split_the_batch_evenly():
    cfg = get_reduced("granite_3_2b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    m, v = init_opt_state(model)
    batch = {k: torch.from_numpy(a) for k, a in _packed_batches(cfg, 1)[0].items()}
    with pytest.raises(ValueError, match="micro-batches"):
        make_lm_train_step(cfg, micro_batches=3)(model, m, v, batch, 0)


def test_grad_norm_is_the_global_l2_norm_of_the_gradients():
    cfg = get_reduced("musicgen_large")
    model = tm.init_params(cfg, torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(a) for k, a in _packed_batches(cfg, 1)[0].items()}
    loss, _ = tm.forward_train(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    m, v = init_opt_state(model)
    _, _, _, loss2, gnorm = make_lm_train_step(cfg)(model, m, v, batch, 0)
    assert float(loss2) == float(loss.detach())
    np.testing.assert_allclose(float(gnorm), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# sequence packing and the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,n_ranks", [(256, 4), (4096, 8)])
def test_sequence_packing_equals_jax(seq_len, n_ranks):
    rng = np.random.default_rng(seq_len)
    lengths = rng.integers(8, min(seq_len, 2000), size=300)
    token_fn = lambda d, ln: np.random.default_rng(d).integers(1, 500, size=ln)  # noqa: E731
    for fn in (None, token_fn):
        got, want = pack_documents(lengths, seq_len, n_ranks, fn), jpack(lengths, seq_len,
                                                                          n_ranks, fn)
        for name in ("tokens", "segment_ids", "positions"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert got.doc_ids == want.doc_ids
    assert packing_stats(lengths, seq_len, n_ranks) == jstats(lengths, seq_len, n_ranks)


def test_lm_cell_cost_equals_jax_for_every_arch_and_shape():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        jcfg = __import__("repro.configs", fromlist=["get_config"]).get_config(arch)
        for name, shape in LM_SHAPES.items():
            assert lm_cell_cost(cfg, shape) == jcost(jcfg, shape), (arch, name)
        red = get_reduced(arch)
        shape = {"kind": "train", "batch": 2, "seq": 64}
        assert lm_cell_cost(red, shape) == jcost(jget_reduced(arch), shape), arch
    for S, w in ((100, None), (100, 30), (10, 30), (64, 64)):
        assert _avg_causal_kv(S, w) == javg(S, w)


def test_granite_train_step_model_flops_and_the_bf16_peak():
    """The model FLOPs of the card's full-width granite step (2 x 2,048
    tokens), and NVIDIA's dense bf16 rate of the H100 SXM."""
    cost = lm_cell_cost(get_config("granite_3_2b"), {"kind": "train", "batch": 2, "seq": 2048})
    assert cost["model_flops"] == pytest.approx(6.23e13, rel=1e-3)
    assert cost["flops"] > cost["model_flops"]
    assert HW().peak_flops_bf16 == 989e12


# ---------------------------------------------------------------------------
# the entry points and the serving engine, on the CPU
# ---------------------------------------------------------------------------


def test_lm_pretrain_runs_on_the_cpu_and_the_loss_falls():
    args = lm_pretrain.parse_args(["--device", "cpu", "--arch", "granite-3-2b", "--steps", "4",
                                   "--batch", "2"])
    losses = lm_pretrain.pretrain(args)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_pretrain.pretrain(lm_pretrain.parse_args(["--steps", "1"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve(serve.parse_args(["--requests", "1"]))


@pytest.mark.parametrize("arch", ["gemma3-4b", "xlstm-125m", "jamba-v0.1-52b"])
def test_serve_runs_on_the_cpu_with_a_padded_tail_and_census_zero(arch):
    args = serve.parse_args(["--device", "cpu", "--arch", arch, "--requests", "5",
                             "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    res = serve.serve(args)
    assert res["stats"]["census"] == {"prefill": 0, "decode": 0}
    assert res["tokens"].shape == (5, 4)
    cfg = serve.serving_config(arch, "reduced")
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()


def test_serving_engine_greedy_tokens_equal_the_plain_calls():
    """The engine's prefill + decode over its static buffers gives the
    tokens of ``forward_prefill`` + ``decode_step`` called directly, and a
    prompt batch of another shape raises."""
    cfg = get_reduced("qwen3_moe_235b_a22b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(3))
    prompts = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (3, 10)).astype(np.int32))
    engine = LMServeEngine(model, cfg, 3, 10, device="cpu")
    engine.warmup()
    got = [engine.prefill(prompts)[0].clone()]
    got += [engine.decode(10 + i)[0].clone() for i in range(4)]
    got = torch.cat(got, 1)
    with torch.no_grad():
        logits, state = tm.forward_prefill(model, cfg, prompts)
        want = [torch.argmax(logits, -1, keepdim=True)]
        for i in range(4):
            logits, state = tm.decode_step(model, state, cfg, want[-1].to(torch.int32), 10 + i)
            want.append(torch.argmax(logits, -1, keepdim=True))
    np.testing.assert_array_equal(got.numpy(), torch.cat(want, 1).numpy())
    assert engine.compile_census() == {"prefill": 0, "decode": 0}
    with pytest.raises(ValueError, match="this engine serves"):
        engine.prefill(prompts[:2])
    with pytest.raises(ValueError, match="this engine serves"):
        engine.prefill(prompts.long())


def test_serve_refuses_out_of_range_token_ids():
    with pytest.raises(ValueError, match="vocab"):
        serve.check_tokens(np.array([[0, 512]]), 512)
    serve.check_tokens(np.array([[0, 511]]), 512)


def test_full_serving_config_stores_bf16_parameters():
    cfg = serve.serving_config("granite-3-2b", "full")
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.n_layers) == (
        torch.bfloat16, torch.bfloat16, 40)
    assert serve.serving_config("granite-3-2b", "reduced") == get_reduced("granite_3_2b")
    assert isinstance(serve.parse_args([]), argparse.Namespace)
