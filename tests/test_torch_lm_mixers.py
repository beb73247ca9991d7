"""Port parity, LM mixers: attention (qk-norm, QKV bias, window, the
slot-aligned cache of ``return_kv``), Mamba, mLSTM, sLSTM and MoE of
``repro_torch.models`` against the JAX package's ``models/``, train path
and decode path, on the same parameters (the JAX initialisers' draws) and
numpy inputs, on the CPU.

Sequences are longer than the scan chunks, so the chunk carries of Mamba
and the mLSTM are exercised; the sLSTM's GELU is the tanh approximation.
MoE is held with capacity drops, through the grouped (sequence-chunk)
path, and with a router whose probabilities tie (``jax.lax.top_k`` takes
the lower expert index).  Tolerance 2e-5 (tests/test_kernels.py), 2e-4 for
gradients (tests/test_backward.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro.models import mamba as jmb
from repro.models import moe as jmoe
from repro.models import xlstm as jx
from repro.models.model import ArchConfig as JConfig
from repro_torch.models import attention as ta
from repro_torch.models import mamba as tmb
from repro_torch.models import moe as tmoe
from repro_torch.models import xlstm as tx
from repro_torch.models.model import ArchConfig as TConfig

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BASE = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, vocab=64,
            attn_chunk=8)


def _cfgs(**kw):
    return JConfig(**{**BASE, **kw}), TConfig(**{**BASE, **kw})


def _params(init, cfg, seed=0):
    jp = init(jax.random.PRNGKey(seed), cfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "plain": dict(),
    "qk_norm": dict(qk_norm=True),
    "qkv_bias": dict(qkv_bias=True),
}


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_train_and_cache_match_jax(case, window):
    jc, tc = _cfgs(**ATTN_CASES[case])
    jp, tp = _params(ja.init_attention, jc)
    if jc.qkv_bias:  # the initialiser's zeros would hide a missing bias
        for n in ("bq", "bk", "bv"):
            b = _x(jp[n].shape, seed=hash(n) % 100, scale=0.3)
            jp[n], tp[n] = jnp.asarray(b), torch.from_numpy(b)
    B, S = 2, 13
    x = _x((B, S, jc.d_model))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.concatenate([np.ones((B, 5), np.int32), np.full((B, 8), 2, np.int32)], 1)
    want, wkv = ja.attention_train(jp, jc, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(seg),
                                   window, return_kv=True)
    got, gkv = ta.attention_train(tp, tc, torch.from_numpy(x), torch.from_numpy(pos),
                                  torch.from_numpy(seg), window, return_kv=True)
    _close(got, want)
    _close(gkv, wkv)
    if window:
        assert gkv["k"].shape[1] == window
        np.testing.assert_array_equal(gkv["pos"].numpy()[0] % window, np.arange(window))


def test_attention_decode_matches_jax():
    jc, tc = _cfgs(qk_norm=True)
    jp, tp = _params(ja.init_attention, jc)
    B, S_max = 2, 10
    ck = _x((B, S_max, jc.n_kv_heads, jc.head_dim), seed=2)
    cv = _x((B, S_max, jc.n_kv_heads, jc.head_dim), seed=3)
    x = _x((B, 1, jc.d_model), seed=4)
    for pos in (0, 6):
        want = ja.attention_decode(jp, jc, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                   jnp.asarray(ck), jnp.asarray(cv), None)
        got = ta.attention_decode(tp, tc, torch.from_numpy(x),
                                  torch.tensor(pos, dtype=torch.int32),
                                  torch.from_numpy(ck), torch.from_numpy(cv), None)
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def test_mamba_train_state_and_decode_match_jax():
    jc, tc = _cfgs(mamba_d_state=8)
    jp, tp = _params(jmb.init_mamba, jc)
    B, S = 2, 24
    x = _x((B, S, jc.d_model))
    want, wst = jmb.mamba_train(jp, jc, jnp.asarray(x), chunk=8, return_state=True)
    got, gst = tmb.mamba_train(tp, tc, torch.from_numpy(x), chunk=8, return_state=True)
    _close(got, want)
    _close(gst, wst)
    xd = _x((B, 1, jc.d_model), seed=5)
    for _ in range(2):
        want, wst = jmb.mamba_decode(jp, jc, jnp.asarray(xd), wst)
        got, gst = tmb.mamba_decode(tp, tc, torch.from_numpy(xd), gst)
        _close(got, want)
        _close(gst, wst)
        xd = np.array(want)


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, 11, 3)).astype(np.float64))
    b = torch.from_numpy(rng.normal(size=(2, 11, 3)))
    gates, hs = tmb.linear_scan(a, b)
    h, g = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
    for t in range(11):
        h, g = a[:, t] * h + b[:, t], g * a[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h.numpy(), rtol=1e-12)
        np.testing.assert_allclose(gates[:, t].numpy(), g.numpy(), rtol=1e-12)


def test_mamba_gradients_match_jax():
    jc, tc = _cfgs(mamba_d_state=8)
    jp, tp = _params(jmb.init_mamba, jc)
    x = _x((2, 16, jc.d_model))
    want = jax.grad(lambda p: jnp.sum(jmb.mamba_train(p, jc, jnp.asarray(x), chunk=8) ** 2))(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = (tmb.mamba_train(tp, tc, torch.from_numpy(x), chunk=8) ** 2).sum()
    got = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    _close(got, want, GRAD_TOL)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


def test_mlstm_train_state_and_decode_match_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jx.init_mlstm, jc)
    B, S = 2, 24
    x = _x((B, S, jc.d_model))
    want, wst = jx.mlstm_train(jp, jc, jnp.asarray(x), chunk=8, return_state=True)
    got, gst = tx.mlstm_train(tp, tc, torch.from_numpy(x), chunk=8, return_state=True)
    _close(got, want)
    _close(gst, wst)
    xd = _x((B, 1, jc.d_model), seed=5)
    want, wst = jx.mlstm_decode(jp, jc, jnp.asarray(xd), wst)
    got, gst = tx.mlstm_decode(tp, tc, torch.from_numpy(xd), gst)
    _close(got, want)


def test_mlstm_from_its_initial_state_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jx.init_mlstm, jc, seed=3)
    xd = _x((2, 1, jc.d_model), seed=7)
    want, wst = jx.mlstm_decode(jp, jc, jnp.asarray(xd), jx.init_mlstm_state(jc, 2))
    got, gst = tx.mlstm_decode(tp, tc, torch.from_numpy(xd), tx.init_mlstm_state(tc, 2))
    _close(got, want)
    _close(gst, wst)


def test_slstm_train_state_and_decode_match_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jx.init_slstm, jc)
    B, S = 2, 12
    x = _x((B, S, jc.d_model))
    want, wst = jx.slstm_train(jp, jc, jnp.asarray(x), return_state=True)
    got, gst = tx.slstm_train(tp, tc, torch.from_numpy(x), return_state=True)
    _close(got, want)
    _close(gst, wst)
    xd = _x((B, 1, jc.d_model), seed=5)
    want, wst = jx.slstm_decode(jp, jc, jnp.asarray(xd), wst)
    got, gst = tx.slstm_decode(tp, tc, torch.from_numpy(xd), gst)
    _close(got, want)
    _close(gst, wst)


def test_slstm_gelu_is_the_tanh_approximation():
    """The sLSTM block's GELU is ``jax.nn.gelu``'s default (tanh); the exact
    erf form differs from it by more than the tolerance."""
    u = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(u)))
    t = torch.from_numpy(u)
    np.testing.assert_allclose(torch.nn.functional.gelu(t, approximate="tanh").numpy(), want,
                               **TOL)
    assert np.abs(torch.nn.functional.gelu(t).numpy() - want).max() > 1e-4


def test_xlstm_gradients_match_jax():
    jc, tc = _cfgs()
    x = _x((2, 16, jc.d_model))
    for init, jfn, tfn in ((jx.init_mlstm, lambda p, x: jx.mlstm_train(p, jc, x, chunk=8),
                            lambda p, x: tx.mlstm_train(p, tc, x, chunk=8)),
                           (jx.init_slstm, lambda p, x: jx.slstm_train(p, jc, x),
                            lambda p, x: tx.slstm_train(p, tc, x))):
        jp, tp = _params(init, jc)
        want = jax.grad(lambda p: jnp.sum(jfn(p, jnp.asarray(x)) ** 2))(jp)
        tp = {k: v.requires_grad_(True) for k, v in tp.items()}
        got = dict(zip(tp, torch.autograd.grad((tfn(tp, torch.from_numpy(x)) ** 2).sum(),
                                               list(tp.values()))))
        _close(got, want, GRAD_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # name: (cfg overrides, B, S, capacity_factor, group_size, zero router)
    "drops": (dict(n_experts=4, top_k=2), 2, 16, 0.5, 2048, False),
    "grouped": (dict(n_experts=4, top_k=2), 2, 24, 1.25, 16, False),
    "grouped_drops": (dict(n_experts=8, top_k=2), 4, 12, 0.5, 20, False),
    "tied_router": (dict(n_experts=4, top_k=2), 2, 8, 1.0, 2048, True),
    "decode": (dict(n_experts=4, top_k=2), 3, 1, 1.25, 2048, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_jax(case):
    over, B, S, cf, group, zero_router = MOE_CASES[case]
    jc, tc = _cfgs(**over)
    jp, tp = _params(jmoe.init_moe, jc)
    if zero_router:  # every probability ties: experts 0 and 1 take every token
        jp["router"] = jnp.zeros_like(jp["router"])
        tp["router"] = torch.zeros_like(tp["router"])
    x = _x((B, S, jc.d_model))
    want, waux = jmoe.apply_moe(jp, jc, jnp.asarray(x), capacity_factor=cf, group_size=group)
    got, gaux = tmoe.apply_moe(tp, tc, torch.from_numpy(x), capacity_factor=cf,
                               group_size=group)
    _close(got, want)
    _close(gaux, waux)
    if zero_router:
        C = tmoe.capacity(tc, B * S, cf)
        served = (np.abs(got.numpy().reshape(B * S, -1)).sum(-1) > 0).sum()
        assert C < B * S and served == C  # the first C tokens fit, the rest drop


def test_moe_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = tmoe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_gradients_match_jax():
    jc, tc = _cfgs(n_experts=4, top_k=2)
    jp, tp = _params(jmoe.init_moe, jc)
    x = _x((2, 12, jc.d_model))

    def jloss(p):
        y, aux = jmoe.apply_moe(p, jc, jnp.asarray(x), capacity_factor=0.75, group_size=8)
        return jnp.sum(y ** 2) + aux

    want = jax.grad(jloss)(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    y, aux = tmoe.apply_moe(tp, tc, torch.from_numpy(x), capacity_factor=0.75, group_size=8)
    got = dict(zip(tp, torch.autograd.grad((y ** 2).sum() + aux, list(tp.values()))))
    _close(got, want, GRAD_TOL)


def test_moe_capacity_is_a_multiple_of_four_at_least_four():
    _, tc = _cfgs(n_experts=8, top_k=2)
    assert [tmoe.capacity(tc, t, 1.25) for t in (1, 8, 13, 100)] == [4, 4, 8, 32]
    assert tmoe.capacity(dataclasses.replace(tc, top_k=1), 64, 0.5) == 4
