"""Port parity, LM layers: ``rms_norm``, ``rope`` and ``chunked_attention``
of ``repro_torch.models.layers`` against the JAX package's
``models/layers.py`` on the same numpy inputs, on the CPU.

Attention's training path is held with KV padding (the length not a
multiple of the chunk), a sliding window, packed segments and an explicit
validity mask; its decode path (``Sq == 1``) on a ring-buffer cache with
unwritten slots, with and without a window.  Tolerance 2e-5, the
reference's kernel-against-oracle bound (tests/test_kernels.py); the
gradient through the checkpointed chunks 2e-4 (tests/test_backward.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3.0
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    for eps in (1e-6, 1e-2):
        want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), eps))
        np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w), eps).numpy(), want, **TOL)


def test_rms_norm_bf16_input_keeps_dtype_and_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    got = tl.rms_norm(_t(x).to(torch.bfloat16), _t(w))
    assert got.dtype == torch.bfloat16
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(tl.rope(_t(x), _t(pos), theta).numpy(), want, **TOL)


def _qkv(rng, B, Sq, Skv, Hq, Hkv, dh):
    q = rng.normal(size=(B, Sq, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    return q, k, v


TRAIN_CASES = {
    # name: (S, chunk, window, segments, kv_valid)
    "one_chunk": (16, 64, None, False, False),
    "padded_chunks": (21, 8, None, False, False),
    "window": (24, 8, 5, False, False),
    "segments": (20, 6, None, True, False),
    "window_segments_valid": (19, 4, 7, True, True),
}


def _train_inputs(name, seed=3):
    S, chunk, window, with_seg, with_valid = TRAIN_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, 2, S, S, 4, 2, 8)
    pos = np.stack([np.arange(S), np.arange(S)]).astype(np.int32)
    kw = dict(q_positions=pos, kv_positions=pos, window=window, chunk=chunk)
    if with_seg:
        seg = np.ones((2, S), np.int32)
        seg[0, S // 3:] = 2
        seg[1, S // 2:] = 2
        seg[1, -3:] = 0
        for b in range(2):  # per-document positions, as packing makes them
            for s in np.unique(seg[b]):
                idx = np.nonzero(seg[b] == s)[0]
                pos[b, idx] = np.arange(len(idx))
        kw.update(q_segments=seg, kv_segments=seg)
    if with_valid:
        kw["kv_valid"] = rng.random((2, S)) < 0.8
        kw["kv_valid"][:, 0] = True
        for b in range(2):
            kw["kv_valid"][b, pos[b] == 0] = True  # every query keeps a key
    return q, k, v, kw


def _jax_attention(q, k, v, kw):
    static = {n: kw[n] for n in ("window", "chunk")}
    arrays = {n: jnp.asarray(a) for n, a in kw.items() if n not in static}
    return np.asarray(jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           **arrays, **static))


def _torch_kw(kw):
    return {n: (a if n in ("window", "chunk") else _t(a)) for n, a in kw.items()}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_chunked_attention_train_path_matches_jax(name):
    q, k, v, kw = _train_inputs(name)
    want = _jax_attention(q, k, v, kw)
    with torch.no_grad():
        got = tl.chunked_attention(_t(q), _t(k), _t(v), **_torch_kw(kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chunked_attention_gradient_through_checkpointed_chunks_matches_jax():
    q, k, v, kw = _train_inputs("window_segments_valid")
    rng = np.random.default_rng(9)
    g = rng.normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        static = {n: kw[n] for n in ("window", "chunk")}
        arrays = {n: jnp.asarray(a) for n, a in kw.items() if n not in static}
        return jnp.sum(jl.chunked_attention(q, k, v, **arrays, **static) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tl.chunked_attention(tq, tk, tv, **_torch_kw(kw))
    got = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_chunked_attention_decode_path_matches_jax(window):
    """One query against a ring-buffer cache: slots hold absolute positions
    out of order, and the unwritten ones (-1) are invalid."""
    rng = np.random.default_rng(4)
    slots, pos = 12, 15
    q, k, v = _qkv(rng, 2, 1, slots, 4, 2, 8)
    cp = np.full((2, slots), -1, np.int32)
    written = np.arange(pos - slots + 1, pos + 1)
    cp[0, written % slots] = written
    cp[1, :9] = np.arange(9)
    kw = dict(q_positions=np.full((2, 1), pos, np.int32), kv_positions=cp,
              kv_valid=cp >= 0, window=window, chunk=4)
    want = _jax_attention(q, k, v, kw)
    got = tl.chunked_attention(_t(q), _t(k), _t(v), **_torch_kw(kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(5)
    p = {n: rng.normal(size=s).astype(np.float32) * 0.2
         for n, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    want = np.asarray(jl.apply_swiglu({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))
    got = tl.apply_swiglu({n: _t(a) for n, a in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
