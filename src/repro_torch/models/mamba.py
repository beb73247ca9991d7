"""Mamba (S6) mixer for Jamba: selective SSM with a chunked scan on the
training path and an O(1)-state decode path.

Port of the JAX package's ``models/mamba.py``.  ``jax.lax.associative_scan``
has no public torch counterpart: within a chunk the linear recurrence
``h_t = dA_t * h_{t-1} + dBx_t`` is composed by log-depth doubling of the
same operator ``(a1, b1) . (a2, b2) = (a1*a2, a2*b1 + b2)``, and the carry of
the previous chunk is injected as ``gates * h0 + hs``, as in the reference.
The SSM state is float32 throughout.

On DTensors the causal conv and the chunk loop run on each rank's local
``[B, c, d_inner, d_state]`` blocks (``loops.run_local``): both run along
the sequence, which no rule splits, so they need no collective (DTensor's
own pad raised an ``IndexError`` in torch 2.11).  The row-parallel ``w_bcdt`` projection leaves a pending sum over
'model' on DTensors; it is all-reduced at once, as GSPMD reduces a
row-parallel matmul, before B, C and dt are sliced from it (left pending,
decode asked DTensor for an ``S(1) -> P(sum)`` redistribute it does not
have).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate

from . import loops
from .layers import make_dense, normal

Params = Dict[str, torch.Tensor]


def init_mamba(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> Params:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    return {
        "w_in": make_dense(gen, d, 2 * di, dtype, device),
        "conv": normal(gen, (dc, di), dtype, device) * 0.2,
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_bcdt": make_dense(gen, di, 2 * ds + dt_rank, dtype, device),
        "w_dt": make_dense(gen, dt_rank, di, dtype, device),
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, di, dtype=torch.float32, device=device))).to(dtype),
        "A_log": torch.log(
            torch.arange(1, ds + 1, dtype=torch.float32, device=device).expand(di, ds)
        ).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "w_out": make_dense(gen, di, d, dtype, device),
    }


def _ssm_params(p: Params, cfg, xz):
    """Common projections.  xz: [B, S, di] (post-conv).  Returns dt, A, B, C."""
    ds = cfg.mamba_d_state
    bcdt = xz @ p["w_bcdt"]                               # [B, S, 2ds+R]
    if isinstance(bcdt, DTensor) and any(q.is_partial() for q in bcdt.placements):
        bcdt = bcdt.redistribute(bcdt.device_mesh, [Replicate() if q.is_partial() else q
                                                     for q in bcdt.placements])
    Bm = bcdt[..., :ds]
    Cm = bcdt[..., ds:2 * ds]
    dt = F.softplus(bcdt[..., 2 * ds:] @ p["w_dt"] + p["dt_bias"])  # [B, S, di]
    A = -torch.exp(p["A_log"].to(torch.float32))          # [di, ds]
    return dt, A, Bm, Cm


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a1, b1) . (a2, b2) = (a1*a2, a2*b1 + b2)`` along
    axis 1 by log-depth doubling: ``(prod_{s<=t} a_s, h_t)`` with ``h_t =
    a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``."""
    c = a.shape[1]
    k = 1
    while k < c:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return a, b


def _conv(xs, conv, conv_b):
    """The causal depthwise conv1d along S, then SiLU."""
    dc, S = conv.shape[0], xs.shape[1]
    xp = F.pad(xs, (0, 0, dc - 1, 0))
    return F.silu(sum(xp[:, i:i + S, :] * conv[i][None, None, :] for i in range(dc)) + conv_b)


def _chunks(dt, xc, Bm, Cm, A, c, d_state):
    """The scan over S/c chunks carrying the SSM state from zero: (y [B, S,
    di] in ``xc``'s dtype, the last state [B, di, ds])."""
    B, S, di = xc.shape
    h = torch.zeros((B, di, d_state), dtype=torch.float32, device=xc.device)
    ys = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        dt_c, xc_c, B_c, C_c = dt[:, sl], xc[:, sl], Bm[:, sl], Cm[:, sl]
        # scan state in f32: the exp-discretised gates are f32
        dA = torch.exp(dt_c[..., None].to(torch.float32) * A[None, None])
        dBx = ((dt_c * xc_c)[..., None] * B_c[:, :, None, :]).to(torch.float32)
        gates, hs = linear_scan(dA, dBx)
        hs = gates * h[:, None] + hs                       # inject carry
        y = torch.einsum("bsdn,bsn->bsd", hs, C_c.to(torch.float32))
        h = hs[:, -1]
        ys.append(y.to(xc_c.dtype))
    return torch.cat(ys, dim=1), h


_CHUNK_DIMS = (("b", "s", "d"), ("b", "s", "d"), ("b", "s", "n"), ("b", "s", "n"), ("d", "n"),
               None, None)


def mamba_train(p: Params, cfg, x: torch.Tensor, chunk: int = 256,
                return_state: bool = False):
    """x: [B, S, d] -> [B, S, d].  A loop over S/chunk chunks carrying the
    SSM state; within a chunk, a parallel scan.  Bounds the
    [B, c, d_inner, d_state] working set."""
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    dc = cfg.mamba_d_conv

    xg = x @ p["w_in"]                                     # [B, S, 2di]
    xs, z = xg[..., :di], xg[..., di:]
    args = (xs, p["conv"], p["conv_b"])
    out = loops.run_local(None, lambda *a: (_conv(*a),), args,
                          (("b", "s", "d"), ("k", "d"), ("d",)), (("b", "s", "d"),), ("b", "d"))
    xc = _conv(*args) if out is None else out[0]

    dt, A, Bm, Cm = _ssm_params(p, cfg, xc)

    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the scan chunk {c}")
    args = (dt, xc, Bm, Cm, A, c, cfg.mamba_d_state)
    out = loops.run_local("mamba_chunks", _chunks, args, _CHUNK_DIMS,
                          (("b", "s", "d"), ("b", "d", "n")), ("b", "d"))
    y, h = _chunks(*args) if out is None else out
    y = y + xc * p["D"]
    y = y * F.silu(z)
    out = y @ p["w_out"]
    if return_state:
        return out, {"h": h, "conv_buf": xs[:, S - (dc - 1):, :]}
    return out


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    return {
        # the SSM state is f32 (exp-gated recurrence); the conv window
        # follows the compute dtype
        "h": torch.zeros((batch, di, cfg.mamba_d_state), dtype=torch.float32, device=device),
        "conv_buf": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p: Params, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """x: [B, 1, d]; O(1) recurrent update."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    dc = cfg.mamba_d_conv

    xg = x[:, 0] @ p["w_in"]
    xs, z = xg[..., :di], xg[..., di:]
    window = torch.cat([state["conv_buf"], xs[:, None, :]], dim=1)   # [B, dc, di]
    xc = torch.einsum("bcd,cd->bd", window, p["conv"]) + p["conv_b"]
    xc = F.silu(xc)

    dt, A, Bm, Cm = _ssm_params(p, cfg, xc[:, None, :])
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]
    dA = torch.exp(dt[..., None].to(torch.float32) * A[None])        # [B, di, ds]
    h = state["h"] * dA + ((dt * xc)[..., None] * Bm[:, None, :]).to(torch.float32)
    y = torch.einsum("bdn,bn->bd", h, Cm.to(torch.float32)).to(xc.dtype)
    y = y + xc * p["D"]
    y = y * F.silu(z)
    out = (y @ p["w_out"])[:, None, :]
    return out, {"h": h, "conv_buf": window[:, 1:dc, :]}
