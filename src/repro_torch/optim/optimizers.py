"""Optimizers (port of ``repro.optim.optimizers``): the reference's
optax-style ``init`` / ``update(grads, state, params, step)`` contract
over trees of dicts, lists and tuples of tensors.

The arithmetic is the reference's, in f32 and in its order: moments
and factored statistics stay f32, gradients are clipped by the global
norm (the leaves' f32 sums of squares added in flatten order, dict keys
sorted), a bf16 gradient is scaled in bf16 before it is widened, and a
parameter is updated in f32 and rounded back to its own dtype.

Unlike the reference's pure functions, ``update`` writes the new
parameters and optimizer state into the tensors it is given and returns
those same tensors: AdamW at 3 B parameters holds 12 GB of weights and
24 GB of moments, and a second copy of each would not fit one card
beside the gradients.  A caller that needs the old values copies them
first.  ``step`` is a 0-d integer tensor (or an int); the schedules
compute in f32 on its device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, Any], Tuple[Tree, Tree]]
    # update(grads, state, params, step) -> (params, state), in place


def _is_state_leaf(x) -> bool:
    """An Adafactor per-parameter state: a dict of its statistics."""
    return isinstance(x, dict) and ("r" in x or "v" in x)


def _leaves(tree: Tree, is_leaf=lambda x: False) -> List:
    """The leaves in JAX's flatten order (dict keys sorted)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def _map(fn: Callable, tree: Tree, *rest: Tree, is_leaf=lambda x: False):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a tree like ``tree``."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, *vs, is_leaf=is_leaf)
                          for vs in zip(tree, *rest))
    return fn(tree, *rest)


def _step(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device)


def _schedule(lr: Union[Schedule, float]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the leaves' f32 sums of squares, added in flatten order."""
    total = None
    for leaf in _leaves(tree):
        sq = torch.sum(leaf.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(grads: Tree, max_norm: float) -> torch.Tensor:
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """New gradients scaled to a global norm of at most ``max_norm``."""
    scale = _clip_scale(grads, max_norm)
    return _map(lambda g: g * scale.to(g.dtype), grads)


def _clipped(g: torch.Tensor, scale) -> torch.Tensor:
    """A gradient clipped in its own dtype, then widened to f32."""
    if scale is None:
        return g.float()
    return (g * scale.to(g.dtype)).float()


def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = _schedule(lr)

    def init(params):
        z = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"mu": z, "nu": _map(torch.zeros_like, z)}

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, max_grad_norm)
        step = _step(step, scale.device)
        t = step.float() + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            g = _clipped(g, scale)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            del g
            u = torch.sqrt(v / bc2).add_(eps)
            u = torch.div(m / bc1, u)
            pf = p.float()
            u.add_(weight_decay * pf).mul_(lr_t)
            p.copy_(pf - u)

        _map(upd, grads, state["mu"], state["nu"], params)
        return params, state

    return Optimizer(init, update)


def adafactor(lr: Union[Schedule, float], decay: float = 0.8,
              eps: float = 1e-30, max_grad_norm: float = 1.0) -> Optimizer:
    """Factored second moment for >=2D params (memory ~ sum of dims)."""
    lr_fn = _schedule(lr)

    def init(params):
        def st(p):
            if p.dim() >= 2:
                return {"r": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "c": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return _map(st, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, max_grad_norm)
        step = _step(step, scale.device)
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def upd(g, p, s):
            g = _clipped(g, scale)
            g2 = g * g + eps
            if p.dim() >= 2:
                s["r"].copy_(beta * s["r"] + (1 - beta) * g2.mean(-1))
                s["c"].copy_(beta * s["c"] + (1 - beta) * g2.mean(-2))
                r, c = s["r"], s["c"]
                denom = (r[..., None] * c[..., None, :]
                         / torch.clamp_min(r.mean(-1, keepdim=True)[..., None],
                                           eps))
                u = g / torch.sqrt(denom + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g / torch.sqrt(s["v"] + eps)
            # update clipping (Shazeer & Stern)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms, 1.0)
            p.copy_(p.float() - lr_t * u)

        for g, p, s in zip(_leaves(grads), _leaves(params),
                           _leaves(state, _is_state_leaf)):
            upd(g, p, s)
        return params, state

    return Optimizer(init, update)


def sgdm(lr: float, momentum: float = 0.9,
         max_grad_norm: float = 0.0) -> Optimizer:
    def init(params):
        return _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, max_grad_norm) if max_grad_norm else None

        def upd(g, m, p):
            m.mul_(momentum).add_(_clipped(g, scale))
            p.copy_(p.float() - lr * m)

        _map(upd, grads, state, params)
        return params, state

    return Optimizer(init, update)


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``; f32 on the step's device."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak * (step + 1) / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn
