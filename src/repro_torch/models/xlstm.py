"""xLSTM mixers (Beck et al., 2024): mLSTM (matrix memory, chunked-parallel
training form, O(1)-state decode) and sLSTM (scalar memory with exponential
gating and a stabiliser, inherently sequential).

Port of the JAX package's ``models/xlstm.py``.  The sLSTM runs one Python
step per time step, as the JAX ``lax.scan`` does one trip per step; on the
card that loop is host-bound by design.  Its GELU is the tanh approximation
(``jax.nn.gelu``'s default, not ``F.gelu``'s).

On DTensors split along batch (and, for the mLSTM, heads) both loops run on
each rank's local shards (``loops.run_local``): each (batch row, head) is
its own recurrence, so nothing is exchanged.  The sLSTM's steps go through
``loops.scan``: on the dry run's meta tensors it traces three steps a layer
and scales the rest (4,096 to 32,768 steps of about 30 ops, at about a
quarter of a millisecond a meta op, do not fit its time limit).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from . import loops
from .layers import make_dense, merge_dims, normal, rms_norm, split_dim

Params = Dict[str, torch.Tensor]

M_INIT = -1e30   # the stabilisers' initial value (float32)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "wq": make_dense(gen, d, d, dtype, device),
        "wk": make_dense(gen, d, d, dtype, device),
        "wv": make_dense(gen, d, d, dtype, device),
        "wi": make_dense(gen, d, H, dtype, device, scale=0.01),
        "bi": torch.zeros((H,), dtype=dtype, device=device),
        "wf": make_dense(gen, d, H, dtype, device, scale=0.01),
        "bf": torch.linspace(3.0, 6.0, H, dtype=torch.float64, device=device).to(dtype),
        "wo_gate": make_dense(gen, d, d, dtype, device),
        "w_out": make_dense(gen, d, d, dtype, device),
        "out_norm": torch.zeros((dh,), dtype=dtype, device=device),
    }


def _mlstm_qkvgates(p: Params, cfg, x):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    q = split_dim(x @ p["wq"], 2, (H, dh)) / math.sqrt(dh)
    k = split_dim(x @ p["wk"], 2, (H, dh))
    v = split_dim(x @ p["wv"], 2, (H, dh))
    li = (x @ p["wi"] + p["bi"]).to(torch.float32)               # [B, S, H]
    lf = _log_sigmoid((x @ p["wf"] + p["bf"]).to(torch.float32))
    return q, k, v, li, lf


def _log_sigmoid(z):
    """``F.logsigmoid``, whose backward has no DTensor sharding strategy;
    on a DTensor the same function from pointwise ops, ``min(z, 0) -
    log1p(exp(-|z|))`` (within an ulp of it: the plain path's numbers are
    untouched)."""
    if isinstance(z, DTensor):
        return torch.clamp(z, max=0) - torch.log1p(torch.exp(-torch.abs(z)))
    return F.logsigmoid(z)


def _mlstm_chunk(carry, qc, kc, vc, lic, lfc):
    """One chunk of the stabilised chunkwise-parallel form (the JAX
    ``body``).  carry: C [B,H,dh,dh], n [B,H,dh], m [B,H]."""
    C_p, n_p, m_p = carry
    c = qc.shape[1]
    b = torch.cumsum(lfc, dim=1)                              # [B, c, H]
    a = lic                                                   # [B, c, H]
    # intra-chunk log-decay matrix [B, H, c, c]
    g = b.permute(0, 2, 1)                                    # [B, H, c]
    a_t = a.permute(0, 2, 1)
    log_D = g[:, :, :, None] - g[:, :, None, :] + a_t[:, :, None, :]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=qc.device))
    log_D = log_D.masked_fill(~tri[None, None], float("-inf"))
    m_intra = log_D.amax(-1)                                  # [B, H, c]
    m_inter = g + m_p[:, :, None]
    m_new = torch.maximum(m_intra, m_inter)                   # [B, H, c]
    D = torch.exp(log_D - m_new[..., None])                   # [B, H, c, c]
    inter = torch.exp(m_inter - m_new)                        # [B, H, c]

    qh = qc.permute(0, 2, 1, 3)                               # [B, H, c, dh]
    kh = kc.permute(0, 2, 1, 3)
    vh = vc.permute(0, 2, 1, 3)
    scores = torch.einsum("bhtd,bhsd->bhts", qh, kh) * D      # [B, H, c, c]
    # float32 against a bf16 operand: the operand is widened, as jnp.einsum
    # promotes (a no-op at float32 compute)
    q32, k32, v32 = (t.to(torch.float32) for t in (qh, kh, vh))
    num = torch.einsum("bhts,bhsd->bhtd", scores, v32) + inter[..., None] * torch.einsum(
        "bhtd,bhde->bhte", q32, C_p)
    den = scores.sum(-1) + inter * torch.einsum("bhtd,bhd->bht", q32, n_p)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]

    # carry update (the recurrent form evaluated at the chunk's end)
    m_c = m_new[:, :, -1]                                     # [B, H]
    b_end = g[:, :, -1]                                       # [B, H]
    w_state = torch.exp(b_end[:, :, None] - g + a_t - m_c[:, :, None])
    C_n = torch.exp(b_end + m_p - m_c)[..., None, None] * C_p + torch.einsum(
        "bhs,bhsd,bhse->bhde", w_state, k32, v32)
    n_n = torch.exp(b_end + m_p - m_c)[..., None] * n_p + torch.einsum(
        "bhs,bhsd->bhd", w_state, k32)
    return (C_n, n_n, m_c), h.permute(0, 2, 1, 3)             # [B, c, H, dh]


def _mlstm_chunks(q, k, v, li, lf, c):
    """The S/c chunks from the zero state: (h [B, S, H, dh], C, n, m)."""
    B, S, H, dh = q.shape
    carry = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device),
             torch.zeros((B, H, dh), dtype=torch.float32, device=q.device),
             torch.full((B, H), M_INIT, dtype=torch.float32, device=q.device))
    hs = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        carry, h = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl])
        hs.append(h)
    return (torch.cat(hs, dim=1),) + carry


_MLSTM_DIMS = (("b", "s", "h", "e"),) * 3 + (("b", "s", "h"),) * 2 + (None,)


def mlstm_train(p: Params, cfg, x: torch.Tensor, chunk: int = 256,
                return_state: bool = False):
    """Chunked-parallel stabilised mLSTM.  x: [B, S, d]."""
    S = x.shape[1]
    q, k, v, li, lf = _mlstm_qkvgates(p, cfg, x)

    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the mLSTM chunk {c}")
    args = (q, k, v, li, lf, c)
    out = loops.run_local("mlstm_chunks", _mlstm_chunks, args, _MLSTM_DIMS,
                          (("b", "s", "h", "e"), ("b", "h", "e", "f"), ("b", "h", "e"),
                           ("b", "h")), ("b", "h"))
    h, *carry = _mlstm_chunks(*args) if out is None else out
    h = h.to(x.dtype)                                         # [B, S, H, dh]
    h = rms_norm(h, p["out_norm"])
    h = merge_dims(h, 2, 2) * torch.sigmoid(x @ p["wo_gate"])
    out = h @ p["w_out"]
    if return_state:
        C_f, n_f, m_f = carry
        return out, {"C": C_f, "n": n_f, "m": m_f}
    return out


def init_mlstm_state(cfg, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), M_INIT, dtype=torch.float32, device=device),
    }


def mlstm_decode(p: Params, cfg, x, state) -> Tuple[torch.Tensor, Dict]:
    B, _, d = x.shape
    q, k, v, li, lf = _mlstm_qkvgates(p, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                       # [B, H, dh]
    li, lf = li[:, 0], lf[:, 0]                               # [B, H]
    m_new = torch.maximum(lf + state["m"], li)
    decay = torch.exp(lf + state["m"] - m_new)
    inject = torch.exp(li - m_new)
    C = decay[..., None, None] * state["C"] + inject[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = decay[..., None] * state["n"] + inject[..., None] * k
    q32 = q.to(torch.float32)                                 # as jnp.einsum promotes
    num = torch.einsum("bhd,bhde->bhe", q32, C)
    den = torch.einsum("bhd,bhd->bh", q32, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h = rms_norm(h.to(x.dtype), p["out_norm"])                # [B, H, dh]
    h = merge_dims(h, 1, 2).reshape(B, 1, d) * torch.sigmoid(x @ p["wo_gate"])
    return h @ p["w_out"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ff = int(4 * d / 3 / 64 + 1) * 64
    return {
        "wx": make_dense(gen, d, 4 * d, dtype, device),      # z, i, f, o pre-acts
        "r": normal(gen, (4, H, dh, dh), dtype, device) / math.sqrt(dh),
        "b": torch.cat([torch.zeros((2 * d,), device=device),
                        torch.full((d,), 3.0, device=device),
                        torch.zeros((d,), device=device)]).to(dtype),
        "out_norm": torch.zeros((dh,), dtype=dtype, device=device),
        "up": make_dense(gen, d, 2 * ff, dtype, device),
        "down": make_dense(gen, ff, d, dtype, device),
    }


def _slstm_step(p: Params, cfg, xw, state):
    """xw: [B, 4d] input pre-activations; state: (h, c, n, m) each
    [B, H, dh] (m: the per-unit stabiliser)."""
    B = xw.shape[0]
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    h_p, c_p, n_p, m_p = state
    rec = torch.einsum("bhd,ghde->gbhe", h_p, p["r"])         # [4, B, H, dh]
    pre = split_dim(xw, 1, (4, H, dh)).permute(1, 0, 2, 3) + rec
    z = torch.tanh(pre[0])
    i_t = pre[1].to(torch.float32)
    f_t = pre[2].to(torch.float32)
    o = torch.sigmoid(pre[3])
    m_new = torch.maximum(f_t + m_p, i_t)
    ig = torch.exp(i_t - m_new)
    fg = torch.exp(f_t + m_p - m_new)
    c = fg * c_p + ig * z.to(torch.float32)
    n = fg * n_p + ig
    h = (o.to(torch.float32) * c / torch.clamp(n, min=1e-6)).to(xw.dtype)
    return h, (h, c, n, m_new)


def _slstm_out(p: Params, h: torch.Tensor, B: int, S: int, d: int) -> torch.Tensor:
    h = rms_norm(h, p["out_norm"])                            # [B, S, H, dh] or [B, H, dh]
    h = merge_dims(h, h.dim() - 2, 2).reshape(B, S, d)
    up = h @ p["up"]
    ff = up.shape[-1] // 2
    y = F.gelu(up[..., :ff], approximate="tanh") * up[..., ff:]
    return y @ p["down"]


def _slstm_steps(xw, r, cfg):
    """The S steps from the zero state: (h [B, S, H, dh], h, c, n, m)."""
    S, B, _ = xw.shape
    H = cfg.n_heads
    dh = cfg.d_model // H

    def step(state, x, weights):
        h, state = _slstm_step({"r": weights[0]}, cfg, x[0], state)
        return state, (h,)

    z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=xw.device)
    state, (hs,) = loops.scan(
        "slstm_steps", step, S,
        (torch.zeros((B, H, dh), dtype=xw.dtype, device=xw.device), z0, z0,
         torch.full((B, H, dh), M_INIT, dtype=torch.float32, device=xw.device)),
        (xw,), (r,), dim=1)
    return (hs,) + state


def slstm_train(p: Params, cfg, x: torch.Tensor, return_state: bool = False):
    B, S, d = x.shape
    xw = (x @ p["wx"] + p["b"]).transpose(0, 1)               # [S, B, 4d]
    args = (xw, p["r"], cfg)
    state = ("b", "h", "e")
    out = loops.run_local("slstm_steps", _slstm_steps, args,
                          (("s", "b", "g"), ("g", "h", "e", "f"), None),
                          (("b", "s", "h", "e"),) + (state,) * 4, ("b",))
    hs, *state = _slstm_steps(*args) if out is None else out
    out = _slstm_out(p, hs, B, S, d)                          # [B, S, H, dh] in
    if return_state:
        h_f, c_f, n_f, m_f = state
        return out, {"h": h_f, "c": c_f, "n": n_f, "m": m_f}
    return out


def init_slstm_state(cfg, batch: int, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "h": torch.zeros((batch, H, dh), dtype=dtype, device=device),
        "c": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, H, dh), M_INIT, dtype=torch.float32, device=device),
    }


def slstm_decode(p: Params, cfg, x, state) -> Tuple[torch.Tensor, Dict]:
    B, _, d = x.shape
    xw = x[:, 0] @ p["wx"] + p["b"]
    h, (hn, c, n, m) = _slstm_step(
        p, cfg, xw, (state["h"], state["c"], state["n"], state["m"]))
    return _slstm_out(p, h, B, 1, d), {"h": hn, "c": c, "n": n, "m": m}
