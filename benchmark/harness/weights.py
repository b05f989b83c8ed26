"""The weights of a run, made on the device from the seed.

The program builds its modules with its own initialisation; the harness
then overwrites every parameter with values drawn here, in one large
uniform draw on the device, and hands the same tensors to the reference.
A weight of fan-in n is U(-1, 1) * sqrt(3 g / n) (variance g / n: g = 1
for the actor and the critics, as flax's lecun law, g = 2 for the RND
nets, as their orthogonal(sqrt 2) law); biases are zero, as both laws
have them. The stacked critics' rows are one draw shared by every row (the
program's critics start so). Mode embeddings are standard normals.
"""

from __future__ import annotations

import math

import torch


def _fan_in(name: str, p: torch.Tensor, stacked: bool) -> int:
    # nn.Linear weights are [out, in]; the stacked critics' [rows, 2, in, out]
    return p.shape[2] if stacked else p.shape[-1]


def draw(named: dict, gen: torch.Generator, device) -> dict:
    """named: {module key: (iterable of (name, parameter), gain, stacked)}
    -> {"<key>.<name>": tensor}: every weight from one uniform draw."""
    plan, total = [], 0
    for key, (params, gain, stacked) in named.items():
        for name, p in params:
            full = f"{key}.{name}"
            is_weight = p.dim() >= (3 if stacked else 2)
            if not is_weight:
                plan.append((full, p, None, 0, 0))
                continue
            shape = tuple(p.shape[1:]) if stacked else tuple(p.shape)
            n = math.prod(shape)
            scale = math.sqrt(3.0 * gain / _fan_in(name, p, stacked))
            plan.append((full, p, (shape, scale, stacked), total, n))
            total += n
    u = torch.rand((total,), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for full, p, spec, at, n in plan:
        if spec is None:
            out[full] = torch.zeros(p.shape, device=device)
            continue
        shape, scale, stacked = spec
        w = (u[at:at + n] * scale).reshape(shape)
        out[full] = (w[None].expand(p.shape).clone() if stacked else w)
    return out


@torch.no_grad()
def load(module: torch.nn.Module, key: str, weights: dict):
    """Copy weights["<key>.<name>"] into every parameter of `module`."""
    for name, p in module.named_parameters():
        w = weights[f"{key}.{name}"]
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{key}.{name}: weight {tuple(w.shape)} for a "
                             f"parameter {tuple(p.shape)}")
        p.copy_(w)
