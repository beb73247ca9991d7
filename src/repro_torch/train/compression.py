"""Gradient compression for the data-parallel all-reduce: int8 + error
feedback, on ``torch.distributed``.

Port of the JAX package's ``train/compression.py``.  int8 quantisation cuts
the all-reduce's payload 4x against fp32; error feedback (Karimireddy et
al., 2019) keeps the quantisation residual on the rank and adds it to the
next step's gradient, so the sequence of updates stays unbiased.  The
scale is max-reduced over the group first, so every rank dequantises the
same total the same way and synchronous replicas stay bit-identical.

The wire (where the port departs from the JAX package)
------------------------------------------------------
The JAX collective sums the int8 payloads on an int16 wire, exact up to
``MAX_INT16_GROUP = 258`` ranks (127 * 258 = 32766), with a chunked
two-stage sum past that (``_chunk_size`` / ``_chunk_groups``).
``torch.distributed`` has no such wire: gloo refuses ``int16`` in
``all_reduce`` ("Invalid scalar type"), NCCL has no 16-bit integer type,
and an ``int8`` sum wraps silently (100 + 100 gave -56 on gloo, torch
2.13).  ``int32`` and ``float16`` sum exactly.  So the payload travels as
``float16`` while ``127 * group_size <= 2048`` (at most
``MAX_FP16_GROUP = 16`` ranks: every partial sum of a reduction is then an
integer of magnitude at most 2032, which float16 holds exactly), 2 bytes
an element as on the JAX wire, and as ``int32`` past that, 4 bytes.  Both
sums are exact, so the integer total, and with it every result, is the JAX
collective's bit for bit.  ``_chunk_size`` and ``_chunk_groups`` are kept
as the reference's description of its own wire.

gloo over CUDA tensors: :func:`all_reduce_` stages a CUDA tensor through
host memory explicitly (one copy each way) when the group's backend is
gloo, which is how several rank processes share one card; NCCL reduces on
the card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# largest group whose int8 payloads sum exactly on the JAX package's int16
# wire (127 * 258 = 32766 <= 32767)
MAX_INT16_GROUP = 258
# largest group whose int8 payloads sum exactly on a float16 wire
# (127 * 16 = 2032 <= 2048, the last integer run float16 holds)
MAX_FP16_GROUP = 16

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _chunk_size(axis_size: int, max_group: int = MAX_INT16_GROUP) -> int:
    """Largest divisor of ``axis_size`` that is ``<= max_group`` (the JAX
    wire's stage-1 chunk width; 1 for a prime ``axis_size``)."""
    if axis_size <= 0:
        raise ValueError(f"axis_size must be positive, got {axis_size}")
    for d in range(min(max_group, axis_size), 0, -1):
        if axis_size % d == 0:
            return d
    return 1


def _chunk_groups(axis_size: int, max_group: int = MAX_INT16_GROUP) -> List[List[int]]:
    """Contiguous equal-size partition of the axis (chunk width from
    ``_chunk_size``)."""
    c = _chunk_size(axis_size, max_group)
    return [list(range(i, i + c)) for i in range(0, axis_size, c)]


def wire_dtype(group_size: int) -> torch.dtype:
    """The dtype int8 payloads travel in over a group of ``group_size``
    ranks: float16 up to ``MAX_FP16_GROUP``, int32 past it."""
    return torch.float16 if group_size <= MAX_FP16_GROUP else torch.int32


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place.  Under gloo a CUDA tensor is
    copied to host memory, reduced there and copied back."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def int8_compress_decompress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise to int8 and back.  Returns (g_hat, residual)."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    g_hat = q.to(g.dtype) * scale
    return g_hat, g - g_hat


def compressed_allreduce_ef(
    g: Tensors,
    e: Tensors,
    group=None,
    *,
    group_size: Optional[int] = None,
):
    """Mean of ``g`` over ``group`` through int8 payloads, with rank-local
    error feedback: the counterpart of the JAX ``compressed_psum_ef``.

    The residual ``e`` (what quantisation dropped on this rank last step)
    is added to the gradient, ``c = g + e``; the scale ``max|c| / 127 +
    1e-12`` is max-reduced over the group; ``q = clip(round(c / scale),
    -127, 127)`` is summed exactly (see the module docstring's wire); the
    result is ``total * scale / n`` and the new residual ``c - q * scale``
    stays on the rank.  All in float32, in the JAX expression order
    (``torch.round`` rounds half to even, as ``jnp.round`` does).

    ``g`` and ``e`` are one tensor each, or two sequences of tensors: each
    tensor keeps its own scale, and the whole sequence goes over the wire
    in two collectives (the scales, then the payloads).  Returns
    ``(g_hat_mean, new_e)`` in the same form.

    ``group_size`` is the JAX ``axis_size`` hint: ``1`` is the exact
    identity (no quantisation, the residual untouched), the single-node
    pod's hop; any other value must be the group's size.  Without it the
    group is quantised at whatever size it has, one rank included, as the
    JAX collective is without its hint.
    """
    if group_size == 1:
        return g, e
    n = dist.get_world_size(group)
    if group_size is not None and group_size != n:
        raise ValueError(f"group_size={group_size} but the group has {n} ranks")
    single = isinstance(g, torch.Tensor)
    gs, es = ([g], [e]) if single else (list(g), list(e))
    cs = [gi.to(torch.float32) + ei for gi, ei in zip(gs, es)]
    scales = torch.stack([c.abs().max() for c in cs]) / 127.0 + 1e-12
    all_reduce_(scales, dist.ReduceOp.MAX, group)
    qs = [torch.clamp(torch.round(c / s), -127, 127) for c, s in zip(cs, scales)]
    wire = torch.cat([q.reshape(-1) for q in qs]).to(wire_dtype(n))
    total = all_reduce_(wire, dist.ReduceOp.SUM, group).to(torch.float32)
    g_hat, new_e, at = [], [], 0
    for gi, c, q, s in zip(gs, cs, qs, scales):
        t = total[at:at + c.numel()].view_as(c)
        at += c.numel()
        g_hat.append((t * s / n).to(gi.dtype))
        new_e.append(c - q * s)
    return (g_hat[0], new_e[0]) if single else (g_hat, new_e)


def compressed_allreduce(g: Tensors, group=None) -> Tensors:
    """Quantised-payload mean without error feedback (the counterpart of
    the JAX ``compressed_psum``): the shared max scale makes dequantisation
    identical on every rank."""
    zeros = (torch.zeros_like(g, dtype=torch.float32) if isinstance(g, torch.Tensor)
             else [torch.zeros_like(t, dtype=torch.float32) for t in g])
    return compressed_allreduce_ef(g, zeros, group)[0]
