"""How the model's loops run on DTensors: on local shards, or (on the meta
device, for the dry run) scaled from traced iterations.

The JAX model runs its long loops as ``lax.scan``: XLA compiles the body
once, and the dry run multiplies its collectives by the trip count
(``roofline/hlo.py``).  The port runs them as Python loops, each op through
DTensor's dispatch, and the dry run traces what they dispatch.  Two routes
keep that within reach:

* :func:`run_local` runs a body that exchanges nothing (the attention core,
  the Mamba and mLSTM chunk loops, the sLSTM steps) on each rank's local
  shards through ``local_map``: every iteration runs, as plain-tensor ops,
  with the FLOPs, collectives and live bytes of a run that exchanges
  nothing there (DTensor's own dispatch may gather inside such a body, and
  builds a loop's zero state replicated).  It applies only where every
  input is split along dims the body keeps apart (batch, heads,
  channels); elsewhere the caller runs the DTensors.
* :func:`scan` runs ``n`` iterations of a loop.  On meta tensors in the
  ``"fast"`` mode (the dry run's default) it traces iterations 0, 1 and
  ``n - 1`` and stands one phantom autograd node in for the others: it
  makes their outputs and input gradients with the traced iterations'
  shapes and placements, holds the bytes iteration 1 kept for each (its
  saved tensors, in a blob the autograd graph keeps until the phantom's
  backward), and raises the memory counter's peak by the most iteration
  1 (forward) and ``n - 1`` (backward) rose above their start.
  Iteration ``n - 1`` counts its FLOPs and collectives ``n - 2`` times
  (``roofline.collectives.weighted``).  Real tensors always run every
  iteration: a phantom's values are not computed.

``trace_mode("full")`` turns both routes off (every iteration through
DTensor) and ``trace_mode("local")`` the scaling alone, as the tests
compare; :func:`routes` tells the dry run which route each loop took.

A scaled loop's FLOPs and collectives are the unscaled loop's exactly; its
live bytes are not: iteration ``n - 1`` returns its input gradients
together, where each iteration of the unscaled loop hands each one on as
it is made, so the dry run gives a scaled cell's peak as an estimate.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.roofline.collectives import active_memory, weighted

_MODE = ["fast"]
_ROUTES: Dict[str, str] = {}
_ORDER = ("full", "local", "scaled")


@contextlib.contextmanager
def trace_mode(mode: str):
    """``"fast"`` (local shards, scaled meta loops), ``"local"`` (local
    shards, every iteration) or ``"full"`` (every iteration through
    DTensor)."""
    if mode not in ("fast", "local", "full"):
        raise ValueError(mode)
    _MODE.append(mode)
    try:
        yield
    finally:
        _MODE.pop()


def routes() -> Dict[str, str]:
    """``{loop: route}`` since the last :func:`reset_routes` (a loop that
    took two routes reports the later one of ``full``, ``local``,
    ``scaled``)."""
    return dict(_ROUTES)


def reset_routes() -> None:
    _ROUTES.clear()


def _record(name: str, route: str) -> None:
    if _ORDER.index(route) >= _ORDER.index(_ROUTES.get(name, "full")):
        _ROUTES[name] = route


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------


def run_local(name: str, fn: Callable, args: Sequence, dims: Sequence, out_dims: Sequence,
              free: Tuple[str, ...]):
    """``fn(*args)`` (a tuple of tensors) on each rank's local shards, or
    ``None`` where it cannot run so (no DTensor among ``args``, an input
    split along a dim not in ``free`` or pending a sum, two inputs split
    along different dims by one mesh dim, an output without a split dim,
    or the ``"full"`` mode).  ``dims[i]`` names each dim of ``args[i]``
    (``None`` for a non-tensor), ``out_dims[j]`` each dim of output ``j``.
    Plain tensors join as replicated; an input replicated where another
    is split along a dim it has is split too (a local slice).  The
    gradient of an input replicated over a mesh dim that splits the others
    is pending a sum over that mesh dim (each rank's shards contribute)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None or _MODE[-1] == "full":
        return None
    split = [None] * mesh.ndim
    for a, names in zip(args, dims):
        if not isinstance(a, DTensor):
            continue
        for i, p in enumerate(a.placements):
            if p.is_partial():
                return None
            if p.is_shard():
                logical = names[p.dim]
                if logical not in free or split[i] not in (None, logical):
                    return None
                split[i] = logical
    if any(s is not None and s not in names for names in out_dims for s in split):
        return None

    def placements(names):
        return tuple(Shard(names.index(s)) if s is not None and s in names else Replicate()
                     for s in split)

    from torch.distributed.tensor.experimental import local_map

    in_pl, grad_pl, placed = [], [], []
    for a, names in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            grad_pl.append(None)
            placed.append(a)
            continue
        pl = placements(names)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        in_pl.append(pl)
        grad_pl.append(tuple(Partial() if q.is_replicate() and s is not None else q
                             for q, s in zip(pl, split)))
        placed.append(a)
    if name is not None:
        _record(name, "local")
    return local_map(fn, out_placements=tuple(placements(n) for n in out_dims),
                     in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*placed)


def pad(x: torch.Tensor, widths: Tuple[int, ...], value=0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)``; a DTensor split only along dims it
    does not pad is padded on its local shards (DTensor's own pad raised an
    ``IndexError`` in torch 2.11)."""
    if isinstance(x, DTensor):
        padded = {x.dim() - 1 - i // 2 for i, w in enumerate(widths) if w}
        names = tuple(range(x.dim()))
        out = run_local(None, lambda t: (F.pad(t, widths, value=value),), (x,), (names,),
                        (names,), tuple(d for d in names if d not in padded))
        if out is not None:
            return out[0]
    return F.pad(x, widths, value=value)


# ---------------------------------------------------------------------------
# scaled loops
# ---------------------------------------------------------------------------


def _is_meta(t) -> bool:
    return (t.to_local() if isinstance(t, DTensor) else t).device.type == "meta"


def _spec(t):
    """What :func:`_new` needs to make a tensor like ``t`` (no reference)."""
    if t is None:
        return None
    if isinstance(t, DTensor):
        loc = t.to_local()
        return (tuple(loc.shape), loc.dtype, loc.device, t.device_mesh, tuple(t.placements),
                tuple(t.shape))
    return (tuple(t.shape), t.dtype, t.device, None, None, None)


def _contiguous(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def _new(spec, k=None, dim=0):
    """An empty tensor like ``spec``'s; with ``k``, ``k`` of them stacked
    along ``dim``."""
    if spec is None:
        return None
    shape, dtype, device, mesh, placements, gshape = spec
    if k is not None:
        shape = shape[:dim] + (k,) + shape[dim:]
        if mesh is not None:
            gshape = gshape[:dim] + (k,) + gshape[dim:]
            placements = tuple(Shard(p.dim + 1) if p.is_shard() and p.dim >= dim else p
                               for p in placements)
    loc = torch.empty(shape, dtype=dtype, device=device)
    if mesh is None:
        return loc
    return DTensor.from_local(loc, mesh, placements, run_check=False, shape=gshape,
                              stride=_contiguous(gshape))


def _key(t) -> int:
    return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()._cdata


def storage_bytes(tensors) -> Dict[int, int]:
    """``{storage: bytes}`` of the tensors (a DTensor's local shard's)."""
    out = {}
    for t in tensors:
        s = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def _max_rise(events) -> int:
    top = run = 0
    for n in events:
        run += n
        top = max(top, run)
    return top


def _flat(carry, y):
    """The distinct tensors of ``(carry, y)`` and where each entry is."""
    uniq, where = [], []
    for part in (carry, y):
        idx = []
        for t in part:
            for j, u in enumerate(uniq):
                if u is t:
                    idx.append(j)
                    break
            else:
                idx.append(len(uniq))
                uniq.append(t)
        where.append(idx)
    return uniq, where


def _unflat(outs, where):
    return tuple(outs[j] for j in where[0]), tuple(outs[j] for j in where[1])


class _Shared:
    """What iterations 1 and ``n - 1`` leave for the phantom: the specs of
    iteration 1's carry and outputs, the bytes it kept and the most it
    rose; then the specs of iteration ``n - 1``'s input gradients and the
    most its backward rose."""

    def __init__(self, carry_specs, y_specs, dim, kept, fwd_rise):
        self.carry_specs, self.y_specs, self.dim = carry_specs, y_specs, dim
        self.kept, self.fwd_rise = kept, fwd_rise
        self.grad_specs = None
        self.bwd_rise = 0


def _recording(mem):
    return mem.recording() if mem is not None else contextlib.nullcontext([])


def _blob(nbytes: int) -> torch.Tensor:
    """An empty tensor over a meta storage of ``nbytes`` (its shape is the
    same whatever the bytes, as the checkpoint's recompute requires)."""
    store = torch.empty(nbytes, dtype=torch.uint8, device="meta")
    return torch.empty(0, dtype=torch.uint8, device="meta").set_(
        store.untyped_storage(), 0, (0,), (1,))


class _Phantom(torch.autograd.Function):
    """Iterations 2 to ``n - 2`` at once (``k`` of them): the carry out, and
    each output's ``k`` values stacked along the loop's ``dim``."""

    @staticmethod
    def forward(ctx, shared, k, n_carry, n_x, *inputs):
        mem = active_memory()
        if mem is not None:
            mem.note(mem.live + (k - 1) * shared.kept + shared.fwd_rise)
        outs = [_new(s) for s in shared.carry_specs] + [
            _new(s, k, shared.dim) for s in shared.y_specs]
        ctx.set_materialize_grads(False)
        ctx.shared, ctx.k, ctx.n_carry, ctx.n_x = shared, k, n_carry, n_x
        ctx.save_for_backward(_blob(k * shared.kept if mem is not None else 0))
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        shared = ctx.shared
        if shared.grad_specs is None:
            raise RuntimeError("the phantom iterations' backward ran before the last one's")
        mem = active_memory()
        blob, = ctx.saved_tensors
        if mem is not None:
            mem.note(mem.live + shared.bwd_rise)
            mem.release(blob)
        del blob
        specs, c, x = shared.grad_specs, ctx.n_carry, ctx.n_x
        return (None,) * 4 + tuple(
            _new(s, ctx.k) if c <= i < c + x else _new(s) for i, s in enumerate(specs))


def _checkpoint_phase() -> str:
    """``"forward"`` inside a non-reentrant checkpoint's first forward (its
    saved tensors are dropped), ``"recompute"`` inside its recomputation,
    else ``""``."""
    hooks = torch._C._autograd._top_saved_tensors_default_hooks(False)
    name = getattr(hooks[0], "__qualname__", "") if hooks else ""
    if name.startswith("_checkpoint_hook"):
        return "forward"
    if name.startswith("_recomputation_hook"):
        return "recompute"
    return ""


class _Weighted(torch.autograd.Function):
    """Iteration ``n - 1``: its forward and backward counted ``w`` times;
    its backward's rise and input gradients are the phantoms'.

    Its own graph is built where the step's saved tensors are kept: not in
    a checkpoint's first forward (which drops them: the step runs without
    one), and in its recomputation outside the checkpoint's hooks, handed
    to the backward on the token the recomputation keeps (a backward
    inside a backward is a graph task of its own, and unpacking a
    checkpoint's tensors there would recompute the region again)."""

    @staticmethod
    def forward(ctx, step, w, shared, n_carry, n_x, *inputs):
        ctx.set_materialize_grads(False)   # an output nothing uses has no gradient
        phase = _checkpoint_phase()
        token = torch.empty(0, device="meta")   # carries the step's graph to the backward
        det = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        graph = contextlib.nullcontext() if phase != "recompute" else \
            torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)
        with torch.set_grad_enabled(phase != "forward"), graph, weighted(w):
            carry, y = step(tuple(det[:n_carry]), tuple(det[n_carry:n_carry + n_x]),
                            tuple(det[n_carry + n_x:]))
        outs, _ = _flat(carry, y)
        if phase != "forward":
            token.inner = (det, outs)
        ctx.w, ctx.shared = w, shared
        ctx.save_for_backward(token)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        token, = ctx.saved_tensors
        det, outs = token.inner
        del token.inner
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        need = [i for i, d in enumerate(det) if d.requires_grad]
        with weighted(ctx.w), _recording(active_memory()) as ev:
            got = torch.autograd.grad([o for o, _ in pairs], [det[i] for i in need],
                                      [g for _, g in pairs], allow_unused=True)
        del outs, pairs
        full = [None] * len(det)
        for i, g in zip(need, got):
            full[i] = g
        ctx.shared.grad_specs = [_spec(g) for g in full]
        ctx.shared.bwd_rise = _max_rise(ev)
        return (None,) * 5 + tuple(full)


def _stack(parts, dim):
    """Per output, its values of the iterations in ``parts`` (tuples of
    single values, or stacked blocks marked by ``True``) along ``dim``."""
    out = []
    for j in range(len(parts[0][1])):
        pieces = [y[j] if block else y[j].unsqueeze(dim) for block, y in parts]
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim))
    return tuple(out)


def scan(name: str, step: Callable, n: int, carry: tuple, xs: tuple, weights: tuple = (),
         dim: int = 0):
    """``for i in range(n): carry, y_i = step(carry, x_i, weights)`` with
    ``x_i = tuple(t[i] for t in xs)``; returns ``(carry, ys)``, ``ys`` each
    output's values stacked along ``dim`` (``torch.stack``).  ``carry``,
    ``xs``, ``weights`` and each ``y_i`` are tuples of tensors; ``step``
    reads nothing else that requires a gradient.  Scaled (module
    docstring) on meta tensors in the ``"fast"`` mode when ``n >= 4``."""
    probe = [t for t in carry + tuple(xs) + tuple(weights) if isinstance(t, torch.Tensor)]
    scaled = _MODE[-1] == "fast" and n >= 4 and probe and all(_is_meta(t) for t in probe)
    del probe
    if not scaled:
        ys = []
        for i in range(n):
            carry, y = step(carry, tuple(t[i] for t in xs), weights)
            ys.append(y)
        return carry, tuple(torch.stack([y[j] for y in ys], dim) for j in range(len(ys[0])))
    _record(name, "scaled")
    mem = active_memory()
    carry, y0 = step(carry, tuple(t[0] for t in xs), weights)
    # iteration 1: what it keeps once the loop lets go of the carry it was given
    held = {_key(t) for t in y0}
    dropped = sum(b for k, b in storage_bytes(carry).items() if k not in held)
    with _recording(mem) as ev:
        carry, y1 = step(carry, tuple(t[1] for t in xs), weights)
    outs, where = _flat(carry, y1)
    made = sum(storage_bytes(outs).values())
    shared = _Shared([_spec(t) for t in carry], [_spec(t) for t in y1], dim,
                     max(0, sum(ev) - made + dropped), _max_rise(ev))
    n_carry, n_x, k = len(carry), len(xs), n - 3
    block = _Phantom.apply(shared, k, n_carry, n_x, *carry, *(t[2:n - 1] for t in xs),
                           *weights)
    carry, y_mid = tuple(block[:n_carry]), tuple(block[n_carry:])
    x = tuple(t[n - 1] for t in xs)
    inputs = carry + x + tuple(weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        carry, y = _unflat(_Weighted.apply(step, n - 2, shared, n_carry, n_x, *inputs), where)
    else:
        with weighted(n - 2):
            carry, y = step(carry, x, weights)
    return carry, _stack([(False, y0), (False, y1), (True, y_mid), (False, y)], dim)
