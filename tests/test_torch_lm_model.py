"""Port parity, the LM family: ``repro_torch.models.model`` against the JAX
package's ``models/model.py`` for each of the ten architectures, at its
``REDUCED`` config, on the JAX initial parameters carried over by
``bridge.lm_params_from_jax`` and the same numpy batch, on the CPU:
``forward_train``'s loss and metrics, its gradients, ``forward_prefill``'s
logits and decode state, and three ``decode_step``s.  Then the port alone:
remat on equals remat off, the full configs' parameter counts, and the
contracts of tests/test_archs_smoke.py (prefill-then-decode consistency,
the ring buffer's wrap on gemma3, packed-segment isolation), and the
reference's decode-eviction quirk on both sides.

Tolerances: forwards, prefill and decode 2e-5 (tests/test_kernels.py),
gradients 2e-4 (tests/test_backward.py); the smoke contracts keep
tests/test_archs_smoke.py's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import model as jm
from repro_torch.bridge import lm_params_from_jax, lm_state_from_jax
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models import model as tm
from repro_torch.models.layers import rms_norm

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 32


def _batch(cfg, seed=0):
    """Two packed documents per row (segments, per-document positions),
    10% of the labels masked."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    lab = np.where(rng.random((B, S)) < 0.9, np.roll(tok, -1, 1), -1).astype(np.int32)
    cut = np.array([11, 20])
    seg = np.where(np.arange(S)[None] < cut[:, None], 1, 2).astype(np.int32)
    pos = np.where(seg == 1, np.arange(S)[None], np.arange(S)[None] - cut[:, None])
    batch = {"tokens": tok, "labels": lab, "positions": pos.astype(np.int32), "segments": seg}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(cfg, jparams):
    return tm.LM(cfg, lm_params_from_jax(_np(jparams), cfg))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_states(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_and_gradients_match_jax(arch):
    jc, tc = jget_reduced(arch), get_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    batch = _batch(jc)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.forward_train(p, jc, b, loss_chunk=12), has_aux=True))(jp, batch)
    model = _model(tc, jp)
    loss, met = tm.forward_train(model, tc, _t(batch), loss_chunk=12)
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(met[k].detach().numpy(), np.asarray(jmet[k]), **TOL)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), **TOL)
    if "moe" in tc.ff_pattern:
        assert float(met["aux"].detach()) > 0
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = dict(_model(tc, jgrads).named_parameters())
    assert len(grads) == len(want)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].detach().numpy(), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_three_decode_steps_match_jax(arch):
    jc, tc = jget_reduced(arch), get_reduced(arch)
    jp = jm.init_params(jax.random.PRNGKey(1), jc)
    batch = _batch(jc, seed=1)
    prefix = batch.get("prefix_embeds")
    jlogits, jstate = jax.jit(lambda p, t, e: jm.forward_prefill(p, jc, t, e))(
        jp, batch["tokens"], prefix)
    model = _model(tc, jp)
    with torch.no_grad():
        logits, state = tm.forward_prefill(
            model, tc, torch.from_numpy(batch["tokens"]),
            None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _close_states(state, lm_state_from_jax(_np(jstate), tc))

    jstep = jax.jit(lambda p, s, t, pos: jm.decode_step(p, s, jc, t, pos))
    tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)
    for i in range(3):
        jlogits, jstate = jstep(jp, jstate, tok, jnp.asarray(S + i, jnp.int32))
        with torch.no_grad():
            logits, state = tm.decode_step(model, state, tc, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _close_states(state, lm_state_from_jax(_np(jstate), tc))
        tok = np.argmax(np.asarray(jlogits), -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_on_equals_remat_off(arch):
    cfg = get_reduced(arch)
    model = tm.init_params(cfg, torch.Generator().manual_seed(2))
    batch = _t(_batch(cfg, seed=2))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _ = tm.forward_train(model, c, batch, loss_chunk=12)
        out[remat] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    np.testing.assert_array_equal(out[True][0].detach().numpy(), out[False][0].detach().numpy())
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_counts_equal_jax(arch):
    jc, tc = jget_config(arch), get_config(arch)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert (tc.period, tc.segments) == (jc.period, jc.segments)
    assert tc.compute_dtype == torch.bfloat16 and tc.param_dtype == torch.float32


def test_registry_resolves_aliases_and_mace():
    assert get_config("granite-3-2b").name == "granite-3-2b"
    assert get_reduced("qwen2.5-3b").name == "qwen2.5-3b-reduced"
    assert get_config("mace_cfm").channels == 128
    assert len({get_config(a).name for a in ARCH_IDS}) == 10


def test_init_params_shapes_match_jax():
    for arch in ("jamba_v0_1_52b", "xlstm_125m", "qwen2_5_3b"):
        jc, tc = jget_reduced(arch), get_reduced(arch)
        want = _model(tc, jm.init_params(jax.random.PRNGKey(0), jc))
        got = tm.init_params(tc, torch.Generator().manual_seed(0))
        assert [(n, p.shape, p.dtype) for n, p in got.named_parameters()] == [
            (n, p.shape, p.dtype) for n, p in want.named_parameters()]


def _train_path_logits(model, cfg, tokens, segments=None, positions=None):
    Bt, St = tokens.shape
    if positions is None:
        positions = torch.arange(St, dtype=torch.int32)[None].expand(Bt, St)
    with torch.no_grad():
        x = tm._embed(cfg, model, tokens, None)
        x, _ = tm._run_segments(cfg, model, x, positions, segments, train=False)
        return x, rms_norm(x, model.final_norm, cfg.norm_eps) @ model.head


def test_prefill_then_decode_consistency():
    """Teacher-forced decode from an empty cache reproduces the training
    forward's last logits (tests/test_archs_smoke.py, 2e-3)."""
    cfg = get_reduced("qwen3_14b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (1, 12)))
    want = _train_path_logits(model, cfg, tokens)[1][:, -1]
    state = tm.init_decode_state(cfg, 1, 12 + 4)
    with torch.no_grad():
        for t in range(12):
            got, state = tm.decode_step(model, state, cfg, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_windowed_decode_wraps_the_ring_buffer():
    """gemma3 at S = 48 > window 32: the local layers' ring buffers wrap and
    decode still equals the training forward (5e-3, as the reference)."""
    cfg = get_reduced("gemma3_4b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(5))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (1, 48)))
    want = _train_path_logits(model, cfg, tokens)[1][:, -1]
    state = tm.init_decode_state(cfg, 1, 48)
    assert state[0]["k"].shape[1] == cfg.window and state[5]["k"].shape[1] == 48
    with torch.no_grad():
        for t in range(48):
            got, state = tm.decode_step(model, state, cfg, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


def test_packed_segments_isolate_documents():
    """Doc B's hidden states do not see doc A."""
    cfg = get_reduced("granite_3_2b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(7))
    t1 = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (1, 24)))
    t2 = t1.clone()
    t2[:, :8] = (t1[:, :8] + 17) % cfg.vocab
    seg = torch.tensor([[1] * 8 + [2] * 16], dtype=torch.int32)
    pos = torch.tensor([list(range(8)) + list(range(16))], dtype=torch.int32)
    h1 = _train_path_logits(model, cfg, t1, seg, pos)[0][:, 8:]
    h2 = _train_path_logits(model, cfg, t2, seg, pos)[0][:, 8:]
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-5)


def test_decode_after_prefill_evicts_prompt_position_zero_as_the_reference_does():
    """``forward_prefill`` builds a global cache of ``prompt_len`` slots, so
    the first decoded token overwrites position 0: both packages give the
    same logits, and both differ from a forward over the longer prompt."""
    jc, tc = jget_reduced("granite_3_2b"), get_reduced("granite_3_2b")
    jp = jm.init_params(jax.random.PRNGKey(9), jc)
    model = _model(tc, jp)
    tokens = np.random.default_rng(10).integers(0, jc.vocab, (2, 9)).astype(np.int32)
    _, jstate = jm.forward_prefill(jp, jc, jnp.asarray(tokens[:, :8]))
    jlogits, _ = jm.decode_step(jp, jstate, jc, jnp.asarray(tokens[:, 8:]),
                                jnp.asarray(8, jnp.int32))
    jfull, _ = jm.forward_prefill(jp, jc, jnp.asarray(tokens))
    with torch.no_grad():
        _, state = tm.forward_prefill(model, tc, torch.from_numpy(tokens[:, :8]))
        assert state[0]["k"].shape[1] == 8
        logits, state = tm.decode_step(model, state, tc, torch.from_numpy(tokens[:, 8:]), 8)
        full, _ = tm.forward_prefill(model, tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)
    np.testing.assert_array_equal(state[0]["pos"].numpy(), [[8, 1, 2, 3, 4, 5, 6, 7]] * 2)
    assert np.abs(logits.numpy() - full.numpy()).max() > 0.1
    assert np.abs(np.asarray(jlogits) - np.asarray(jfull)).max() > 0.1


def test_out_of_range_token_ids_raise():
    """The JAX ``jnp.take`` returns NaN rows for ids past the vocabulary;
    the port's embedding raises."""
    cfg = get_reduced("musicgen_large")
    jc = jget_reduced("musicgen_large")
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    bad = np.array([[1, cfg.vocab]], np.int32)
    jlogits, _ = jm.forward_prefill(jp, jc, jnp.asarray(bad))
    assert np.isnan(np.asarray(jlogits)).all()
    with pytest.raises(IndexError):
        tm.forward_prefill(_model(cfg, jp), cfg, torch.from_numpy(bad))
