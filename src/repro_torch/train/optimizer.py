"""AdamW, EMA, gradient clipping and LR schedules over nested dicts of tensors.

Port of the JAX package's ``train/optimizer.py`` (an optax-lite), written
by hand rather than through ``torch.optim`` so that the algebra is the
reference's, operation for operation, in float32: ``t = step + 1``, bias
corrections ``1 - b**t``, ``eps`` outside the square root, and the EMA
debias ``min(decay, (1 + step) / (10 + step))``.  The paper trains with
Adam + an exponential-moving-average scheduler and lr = 5e-3 (§5.2).

Transforms follow the (init, update) protocol so they compose with
:func:`chain`; their states are trees of the same layout as the JAX
package's (a chain's state is a tuple, AdamW's ``{"m", "v"}``), so a
checkpoint of either restores into the other.  A tree is a nested dict
(or tuple) of tensors; every update runs without autograd.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Tree = Any
Step = Union[int, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of nested dicts and tuples (all trees
    of one structure)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    """Leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _step_tensor(step: Step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


class Transform(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Step], Tuple[Tree, Tree]]
    # update(grads, state, params, step) -> (updates, new_state)


# ----------------------------- schedules ----------------------------------


def constant_lr(lr: float) -> Schedule:
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def exponential_decay_lr(lr: float, decay: float, steps: int) -> Schedule:
    return lambda step: lr * decay ** (step / steps)


def warmup_cosine_lr(lr: float, warmup: int, total: int, floor: float = 0.0) -> Schedule:
    def f(step):
        step = step.to(torch.float32)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return f


# ----------------------------- transforms ---------------------------------


def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        leaves = tree_leaves(grads)
        gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in leaves))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
        return tree_map(lambda g: g * scale, grads), state

    return Transform(init, update)


def adamw(
    lr: Union[Schedule, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Transform:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _step_tensor(step, tree_leaves(params)[0]) + 1.0
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        mh = tree_map(lambda mm: mm / (1 - b1**t), m)
        vh = tree_map(lambda vv: vv / (1 - b2**t), v)
        lr_t = sched(t - 1.0)
        upd = tree_map(
            lambda mm, vv, p: (
                -lr_t * (mm / (torch.sqrt(vv) + eps) + weight_decay * p.to(torch.float32))
            ).to(p.dtype),
            mh, vh, params,
        )
        return upd, {"m": m, "v": v}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params, step):
        new_state = []
        for t, s in zip(transforms, state):
            grads, ns = t.update(grads, s, params, step)
            new_state.append(ns)
        return grads, tuple(new_state)

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u, params, updates)


# ----------------------------- EMA -----------------------------------------


@dataclasses.dataclass
class EMA:
    decay: float = 0.99

    def init(self, params):
        return tree_map(lambda p: p.detach().to(torch.float32).clone(), params)

    @torch.no_grad()
    def update(self, ema_params, params, step: Optional[Step] = None):
        d = self.decay
        if step is not None:  # debias early steps like the paper's scheduler
            s = _step_tensor(step, tree_leaves(params)[0])
            d = torch.clamp((1.0 + s) / (10.0 + s), max=self.decay)
        return tree_map(
            lambda e, p: d * e + (1 - d) * p.to(torch.float32), ema_params, params
        )
