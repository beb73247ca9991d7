"""GQA attention block: qk-norm (qwen3), QKV bias (qwen2.5), sliding window
(mixtral / gemma3 locals), RoPE; train path (chunked flash) + decode path
(single token against a KV cache).

Port of the JAX package's ``models/attention.py``.  The decode path writes
the new key and value at a position held in a device tensor
(``index_copy``), so that a captured CUDA graph can replay it at every
position.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .layers import chunked_attention, make_dense, merge_dims, rms_norm, rope, split_dim

Params = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": make_dense(gen, d, hq * dh, dtype, device),
        "wk": make_dense(gen, d, hkv * dh, dtype, device),
        "wv": make_dense(gen, d, hkv * dh, dtype, device),
        "wo": make_dense(gen, hq * dh, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((dh,), dtype=dtype, device=device)
        p["knorm"] = torch.zeros((dh,), dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, cfg, x, positions):
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_dim(q, 2, (hq, dh))
    k = split_dim(k, 2, (hkv, dh))
    v = split_dim(v, 2, (hkv, dh))
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(
    p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
    segments: Optional[torch.Tensor], window: Optional[int],
    return_kv: bool = False,
):
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = chunked_attention(
        q, k, v,
        q_positions=positions, kv_positions=positions,
        q_segments=segments, kv_segments=segments,
        window=window, chunk=cfg.attn_chunk,
    )
    B, S = x.shape[:2]
    out = merge_dims(out, 2, 2) @ p["wo"]
    if not return_kv:
        return out

    # a ring-buffer cache compatible with decode: the entry for absolute
    # position p lives at slot p % slots
    slots = S if window is None else min(S, window)
    if slots == S:
        ck, cv, cp = k, v, positions
    else:
        keep = torch.arange(S - slots, S, device=x.device)   # last `slots` positions
        order = torch.argsort(keep % slots)                   # slot-aligned permutation
        idx = keep[order]
        ck, cv = k[:, idx], v[:, idx]
        cp = positions[:, idx]
    return out, {"k": ck, "v": cv, "pos": cp.to(torch.int32)}


def attention_decode(
    p: Params, cfg, x: torch.Tensor, pos: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: [B, 1, d]; pos: int32 scalar tensor (current
    position, below ``S_max``); cache_k/v: [B, S_max, Hkv, dh].  Returns
    (out, new_k, new_v)."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos.expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    at = pos.reshape(1).long()
    cache_k = cache_k.index_copy(1, at, k.to(cache_k.dtype))
    cache_v = cache_v.index_copy(1, at, v.to(cache_v.dtype))
    kv_pos = torch.arange(S_max, dtype=torch.int32, device=x.device)[None].expand(B, S_max)
    kv_valid = kv_pos <= pos
    out = chunked_attention(
        q, cache_k, cache_v,
        q_positions=positions, kv_positions=kv_pos, kv_valid=kv_valid,
        window=window, chunk=cfg.attn_chunk,
    )
    out = merge_dims(out, 2, 2) @ p["wo"]
    return out, cache_k, cache_v
