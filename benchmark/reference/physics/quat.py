"""Quaternion algebra (w, x, y, z convention) on `[..., 4]` float32 tensors.

Counterpart of `ddiffpg_tpu/physics/quat.py`, same formulas.
"""

from __future__ import annotations

import torch


def identity(device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The identity rotation [4], on the card unless `device` says
    otherwise."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device, dtype=dtype)


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (active rotation, body->world)."""
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t)


def inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return rotate(conj(q), v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def integrate(q: torch.Tensor, omega_world: torch.Tensor,
              dt) -> torch.Tensor:
    """q <- exp(0.5 * omega * dt) * q for world-frame angular velocity."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.where(angle > 1e-9, angle, 1.0)
    half = angle[..., 0] * dt * 0.5
    dq = torch.cat([torch.cos(half)[..., None],
                    axis * torch.sin(half)[..., None]], dim=-1)
    out = mul(dq, q)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
