"""The optax chains of the update pass, over lists of tensors.

Counterpart of `ddiffpg_tpu/agents/base.py:make_optimizer` (:78) and
`apply_update` (:85), and of the RND chain (`ddiffpg_tpu/intrinsic.py:54`):
`clip_by_global_norm(max_norm)` then `adamw(lr)` (optax's defaults: b1 0.9,
b2 0.999, eps 1e-8, weight decay 1e-4, bias correction), or, without decay,
`adam(lr, eps=1e-5)`. The arithmetic follows optax's order:

    norm = sqrt(sum g^2)            (global, per row)
    g    = g if norm < max_norm else (g / norm) * max_norm
    mu   = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  n = count + 1
    u    = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
    p    = p + (-lr) (u + wd p)

Parameters may carry leading row axes (`rows` of them): the stacked
critics are `[G_max, ...]`, and the action gradient's actions `[G, b, A]`
are one problem per group. Then the global norm, the clip and the step
count are per row, and `apply_update(..., G=G)` moves rows `:G` only, so
rows `G..` keep their parameters, moments and counts bit for bit (no
weight decay, no momentum). `torch.optim.AdamW` has one count per tensor
and another clip (`max_norm / (norm + 1e-6)`), so it cannot serve.
Updates are in place, under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


class OptimizerSpec(NamedTuple):
    lr: float
    max_grad_norm: Optional[float] = 1.0
    weight_decay: float = 1e-4     # 0: optax.adam(lr, eps=1e-5)
    eps: float = 1e-8
    b1: float = 0.9
    b2: float = 0.999


def make_optimizer(lr: float, max_grad_norm: Optional[float],
                   weight_decay: bool = True) -> OptimizerSpec:
    """`ddiffpg_tpu/agents/base.py:make_optimizer`: adamw(lr) with optax's
    default decay, or adam(lr, eps=1e-5), behind the global-norm clip."""
    if weight_decay:
        return OptimizerSpec(lr, max_grad_norm)
    return OptimizerSpec(lr, max_grad_norm, weight_decay=0.0, eps=1e-5)


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: `count` is int32 of the row shape."""
    mu: list
    nu: list
    count: torch.Tensor


def adam_init(params: Sequence[torch.Tensor], rows: int = 0) -> AdamState:
    """Zero moments, and a zero count per row of the first `rows` axes."""
    shape = tuple(params[0].shape[:rows])
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params],
                     count=torch.zeros(shape, dtype=torch.int32,
                                       device=params[0].device))


def global_norm(grads: Sequence[torch.Tensor], rows: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, per row of the first
    `rows` axes (a scalar for rows=0)."""
    return torch.sqrt(sum((g * g).flatten(rows).sum(-1) for g in grads))


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - x.dim()))


def clip_by_global_norm(grads, norm: torch.Tensor, max_norm: float):
    """optax.clip_by_global_norm given the norm: rows whose norm is at
    least max_norm are scaled by (g / norm) * max_norm."""
    keep = norm < max_norm
    return [torch.where(_per_row(keep, g), g,
                        (g / _per_row(norm, g)) * max_norm) for g in grads]


@torch.no_grad()
def adam_step(params, grads, state: AdamState, spec: OptimizerSpec):
    """One optax step (clip, adam(w), apply) on `params` in place; the
    tensors may be views of rows. Returns the pre-clip global norm."""
    rows = state.count.dim()
    norm = global_norm(grads, rows)
    if spec.max_grad_norm is not None:
        grads = clip_by_global_norm(grads, norm, spec.max_grad_norm)
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(spec.b1, c)
    bc2 = 1.0 - torch.pow(spec.b2, c)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        m = (1.0 - spec.b1) * g + spec.b1 * mu
        v = (1.0 - spec.b2) * (g * g) + spec.b2 * nu
        u = (m / _per_row(bc1, m)) / (torch.sqrt(v / _per_row(bc2, v))
                                      + spec.eps)
        if spec.weight_decay:
            u = u + spec.weight_decay * p
        p.copy_(p + (-spec.lr) * u)
        mu.copy_(m)
        nu.copy_(v)
    state.count.copy_(count)
    return norm


def apply_update(params, grads, state: AdamState, spec: OptimizerSpec,
                 G: int | None = None):
    """`ddiffpg_tpu/agents/base.py:apply_update` in place: one step of the
    chain on the gradients averaged across the ranks of a
    `agents/base.py:data_parallel` context (one all_reduce; none outside
    it). With `G`, the tensors' first axis is the row axis of `state` and
    only rows `:G` move; returns the pre-clip norm per moved row."""
    from benchmark.reference.agents.base import maybe_pmean

    if G is None:
        return adam_step(params, maybe_pmean(list(grads)), state, spec)
    sub = AdamState([m[:G] for m in state.mu], [v[:G] for v in state.nu],
                    state.count[:G])
    return adam_step([p[:G] for p in params],
                     maybe_pmean([g[:G] for g in grads]), sub, spec)
