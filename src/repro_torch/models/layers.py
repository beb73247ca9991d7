"""Shared LM layers: norms, RoPE, SwiGLU, and memory-bounded chunked attention.

Port of the JAX package's ``models/layers.py``.  Attention is the same
flash-style algorithm in plain PyTorch: a loop over KV chunks with a running
max and sum, so that no ``[S, S]`` score tensor is materialised, each chunk
under ``torch.utils.checkpoint`` when autograd records it (its probabilities
are recomputed in the backward instead of kept).  It is deliberately not
``F.scaled_dot_product_attention``: the chunking, the padding and the
``NEG_INF`` masking are the reference's, so the numbers are too.

On DTensors split only along batch and heads (train and prefill), the
attention core runs on each rank's local shards (``loops.run_local``):
nothing is exchanged, as GSPMD exchanges nothing there, and DTensor's
einsum, which cannot flatten (B, H) with H sharded (torch 2.11), is never
asked to.  A decode step's cache is split along its slots instead: there
the query's heads are gathered where the cache's are not split (a query is
one token), and DTensor reduces the softmax over the slots.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from . import loops

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped into ``sizes`` (heads, head dim).
    On a DTensor, a mesh dim that shards ``dim`` but does not divide
    ``sizes[0]`` is gathered first (8 KV heads sharded 16 ways): DTensor's
    view cannot split a dim sharded that way without it (torch 2.11)."""
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        placements, n = list(x.placements), 1
        for i, p in enumerate(placements):
            if p.is_shard(dim):
                if sizes[0] % (n * x.device_mesh.size(i)):
                    placements[i] = Replicate()
                else:
                    n *= x.device_mesh.size(i)
        if placements != list(x.placements):
            x = x.redistribute(x.device_mesh, placements)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


class _Merge(torch.autograd.Function):
    """``flatten`` of dims ``dim .. dim + len(sizes) - 1`` whose backward
    splits the gradient with :func:`split_dim`."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.flatten(dim, dim + len(sizes) - 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def merge_dims(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with dims ``dim .. dim + n - 1`` merged into one (heads and
    head dim).  The gradient of a merge splits the merged dim, which may
    arrive sharded by a mesh dim that does not divide the first part: on a
    DTensor the split is :func:`split_dim`'s."""
    if not isinstance(x, DTensor):
        return x.flatten(dim, dim + n - 1)
    return _Merge.apply(x, dim, tuple(x.shape[dim:dim + n]))


def make_dense(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               device=None, scale: Optional[float] = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), dtype, device) * s


def normal(gen: torch.Generator, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard normal draws from ``gen`` (the counterpart of
    ``jax.random.normal``; torch cannot reproduce its stream)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (n * (1.0 + w.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------


def _mask(kp, q_positions, kvld, window, ksg, q_segments):
    """[B, Sq, C] bool: causal, valid, in the window, same segment."""
    mask = kp[:, None, :] <= q_positions[:, :, None]
    if kvld is not None:
        mask = mask & kvld[:, None, :]
    if window is not None:
        mask = mask & (kp[:, None, :] > (q_positions[:, :, None] - window))
    if ksg is not None and q_segments is not None:
        mask = mask & (ksg[:, None, :] == q_segments[:, :, None])
    return mask


def _chunk_step(acc, m, s, q_, kc, vc, kp, kvld, ksg, q_positions, q_segments, window):
    """One KV chunk of the running softmax (the JAX ``body``)."""
    logits = torch.einsum("bqhrd,bchd->bqhrc", q_, kc)
    mask = _mask(kp, q_positions, kvld, window, ksg, q_segments)
    logits = logits.to(torch.float32).masked_fill(~mask[:, :, None, None, :], NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    s_new = s * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bqhrc,bchd->bqhrd", p.to(vc.dtype), vc).to(torch.float32)
    return acc_new, m_new, s_new


def _attention_core(q_, k, v, q_positions, kv_positions, kv_valid, q_segments, kv_segments,
                    window, chunk):
    """[B, Sq, Hkv, rep, dh] of scaled queries ``q_`` against ``k``, ``v``:
    one pass for a single query, else the chunked running softmax."""
    B, Sq, Hkv, rep, dh = q_.shape
    Skv = k.shape[1]
    if Sq == 1:
        # decode: one pass over the whole cache
        logits = torch.einsum("bqhrd,bchd->bqhrc", q_, k).to(torch.float32)
        mask = _mask(kv_positions, q_positions, kv_valid, window, kv_segments, q_segments)
        logits = logits.masked_fill(~mask[:, :, None, None, :], NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bqhrc,bchd->bqhrd", p.to(v.dtype), v)

    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if kv_valid is None:
        kv_valid = torch.ones((B, Skv), dtype=torch.bool, device=q_.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
        kv_valid = F.pad(kv_valid, (0, pad), value=False)
        if kv_segments is not None:
            kv_segments = F.pad(kv_segments, (0, pad), value=-1)

    acc = torch.zeros((B, Sq, Hkv, rep, dh), dtype=torch.float32, device=q_.device)
    m = torch.full((B, Sq, Hkv, rep), NEG_INF, dtype=torch.float32, device=q_.device)
    s = torch.zeros((B, Sq, Hkv, rep), dtype=torch.float32, device=q_.device)
    # flash-attention backward: recompute each chunk's probabilities in the
    # backward instead of keeping [B, Sq, Hq, chunk] softmax tensors per chunk
    remat = torch.is_grad_enabled()
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ksg = kv_segments[:, sl] if kv_segments is not None else None
        args = (acc, m, s, q_, k[:, sl], v[:, sl], kv_positions[:, sl], kv_valid[:, sl],
                ksg, q_positions, q_segments, window)
        if remat:
            acc, m, s = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            acc, m, s = _chunk_step(*args)
    return acc / torch.clamp(s[..., None], min=1e-30)


def _heads_where_cache_is(q_, k):
    """``q_`` with its heads gathered over every mesh dim that splits them
    but not the cache's heads (a decode step's cache is split along its
    slots)."""
    placements = [Replicate() if p.is_shard(2) and not kp.is_shard(2) else p
                  for p, kp in zip(q_.placements, k.placements)]
    if placements == list(q_.placements):
        return q_
    return q_.redistribute(q_.device_mesh, placements)


_CORE_DIMS = (("b", "q", "h", "r", "e"), ("b", "c", "h", "e"), ("b", "c", "h", "e"),
              ("b", "q"), ("b", "c"), ("b", "c"), ("b", "q"), ("b", "c"), None, None)


def chunked_attention(
    q: torch.Tensor,              # [B, Sq, Hq, dh]
    k: torch.Tensor,              # [B, Skv, Hkv, dh]
    v: torch.Tensor,              # [B, Skv, Hkv, dh]
    *,
    q_positions: torch.Tensor,    # [B, Sq] absolute positions of queries
    kv_positions: torch.Tensor,   # [B, Skv]
    kv_valid: Optional[torch.Tensor] = None,    # [B, Skv] bool
    q_segments: Optional[torch.Tensor] = None,  # [B, Sq] packed-seq segment ids
    kv_segments: Optional[torch.Tensor] = None,
    window: Optional[int] = None,  # sliding-window size (None = global)
    chunk: int = 1024,
) -> torch.Tensor:
    """Causal (optionally windowed / packed-segment) attention, O(Skv/chunk)
    memory.  Returns [B, Sq, Hq, dh]."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    q_ = split_dim(q * (1.0 / math.sqrt(dh)), 2, (Hkv, rep))
    args = (q_, k, v, q_positions, kv_positions, kv_valid, q_segments, kv_segments, window,
            chunk)
    out = None
    if isinstance(q_, DTensor):
        out = loops.run_local("attention_chunks", lambda *a: (_attention_core(*a),), args,
                              _CORE_DIMS, (_CORE_DIMS[0],), ("b", "h"))
        if out is None and Sq == 1 and isinstance(k, DTensor):
            args = (_heads_where_cache_is(q_, k),) + args[1:]
    out = _attention_core(*args) if out is None else out[0]
    return merge_dims(out, 2, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d: int, f: int, dtype=torch.float32,
                device=None) -> Params:
    return {
        "wi": make_dense(gen, d, f, dtype, device),
        "wg": make_dense(gen, d, f, dtype, device),
        "wo": make_dense(gen, f, d, dtype, device),
    }


def apply_swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
