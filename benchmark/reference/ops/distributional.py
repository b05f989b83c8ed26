"""C51 categorical projection and the critics' BCE loss.

Counterpart of `ddiffpg_tpu/ops/distributional.py` (the reference's
utils/distl_util.py:4-20), including its l/u tie-breaking. As there, the
projection is a product with one-hot matrices (a batched matmul), so the
sums keep a fixed order on the card (a scatter-add would use atomics).
"""

from __future__ import annotations

import torch


def projection(next_dist: torch.Tensor, reward: torch.Tensor,
               done: torch.Tensor, gamma: float, v_min, v_max,
               num_atoms: int, support: torch.Tensor) -> torch.Tensor:
    """Project `reward + (1 - done) gamma z` onto the fixed support.

    next_dist [..., B, A] probabilities at the next state; reward, done
    [..., B, 1] (or [..., B]); v_min, v_max floats or tensors that
    broadcast against [..., B, A] (per-group supports); support [..., A]
    broadcastable likewise. Returns [..., B, A].
    """
    reward = reward.reshape(*next_dist.shape[:-1], 1)
    done = done.reshape(*next_dist.shape[:-1], 1).to(next_dist.dtype)
    delta_z = (v_max - v_min) / (num_atoms - 1)

    target_z = torch.clamp(reward + (1.0 - done) * gamma * support, v_min,
                           v_max)
    b = (target_z - v_min) / delta_z
    l = torch.floor(b).to(torch.int64)
    u = torch.ceil(b).to(torch.int64)

    # the second adjustment tests the already-updated l (distl_util.py:13-14)
    eq = l == u
    l = torch.where((u > 0) & eq, l - 1, l)
    u = torch.where((l < (num_atoms - 1)) & (l == u), u + 1, u)

    w_l = next_dist * (u.to(b.dtype) - b)
    w_u = next_dist * (b - l.to(b.dtype))
    eye = torch.eye(num_atoms, dtype=next_dist.dtype, device=next_dist.device)
    lead = next_dist.shape[:-1]
    # a target at v_max can put b a hair above num_atoms - 1 (float32
    # division; on the card also a product with the reciprocal): the bin
    # index is clamped, as the JAX package's gather clamps it
    onehot = lambda i: eye[i.clamp(0, num_atoms - 1)].reshape(  # noqa: E731
        -1, num_atoms, num_atoms)
    proj = (torch.bmm(w_l.reshape(-1, 1, num_atoms), onehot(l))
            + torch.bmm(w_u.reshape(-1, 1, num_atoms), onehot(u)))
    return proj.reshape(*lead, num_atoms)


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-7, dim=None) -> torch.Tensor:
    """Elementwise-mean BCE on probabilities (F.binary_cross_entropy's
    value), clipped at eps; `dim` keeps the leading axes (per-group
    losses)."""
    pred = torch.clamp(pred, eps, 1.0 - eps)
    e = target * torch.log(pred) + (1.0 - target) * torch.log1p(-pred)
    return -(e.mean() if dim is None else e.mean(dim=dim))
