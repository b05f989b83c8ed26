"""Intrinsic exploration reward: NovelD (default) and RND.

Counterpart of `ddiffpg_tpu/intrinsic.py` (the reference's IntrinsicM,
utils/intrinsic.py:8-94):
  novelty(s)    = || predictor(s) - target(s) ||_2
  NovelD(s, s') = scale * max(novelty(s') - 0.5 novelty(s), 0)
with the NeRF positional encoding of the position channels (xy on the
mazes, xyz on manipulation) before the RND nets, and, with `normalize`,
running-std normalisation of novelty once `update_step > warm_up`. The
warm-up test stays on the device (`torch.where`), so no call waits on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.models.mlp import RNDModel
from benchmark.reference.ops import optim
from benchmark.reference.ops import running_stats as rs
from benchmark.reference.ops.posenc import posenc


class IntrinsicState(NamedTuple):
    net: RNDModel
    opt_state: optim.AdamState
    rms: rs.RunningMeanStd
    update_step: torch.Tensor    # int32 scalar


class IntrinsicModule:
    def __init__(self, obs_dim: int, kind: str = "noveld", pos_dim: int = 2,
                 normalize: bool = False, pos_enc: bool = True, L: int = 10,
                 warm_up: int = 1000, lr: float = 1e-4, scale: float = 0.01,
                 depth_scale: float = 0.0):
        if kind not in ("noveld", "rnd"):
            raise ValueError(f"unknown intrinsic type {kind!r}")
        self.kind = kind
        self.pos_dim = pos_dim
        self.normalize = normalize
        self.pos_enc = pos_enc
        self.L = L
        self.warm_up = warm_up
        self.scale = scale
        self.depth_scale = depth_scale
        self.obs_dim = obs_dim
        self.in_dim = obs_dim + (pos_dim * 2 * L if pos_enc else 0)
        self.spec = optim.OptimizerSpec(lr, max_grad_norm=1.0)

    def init(self, device="cuda",
             generator: torch.Generator | None = None) -> IntrinsicState:
        net = RNDModel(self.in_dim, generator=generator).to(device)
        return IntrinsicState(
            net=net, opt_state=optim.adam_init(net.params()),
            rms=rs.RunningMeanStd.create((), device=device),
            update_step=torch.zeros((), dtype=torch.int32, device=device))

    def encode(self, obs):
        if not self.pos_enc:
            return obs
        pos = posenc(obs[:, :self.pos_dim], self.L)
        return torch.cat([pos, obs[:, self.pos_dim:]], dim=-1)

    def novelty(self, net: RNDModel, obs_encoded):
        pred, tgt = net(obs_encoded)
        return torch.linalg.vector_norm(pred - tgt, dim=-1)

    @torch.no_grad()
    def compute_reward(self, state: IntrinsicState, obs, next_obs=None):
        """(reward [B, 1], new state); the rms moves only with
        `normalize`."""
        nov = self.novelty(state.net, self.encode(obs))
        rms = state.rms
        warm = state.update_step > self.warm_up

        if self.kind == "rnd":
            if self.normalize:
                rms = rs.where(warm, rs.update(rms, nov), rms)
                nov = torch.where(warm, rs.normalize(rms, nov), nov)
            return nov[:, None], state._replace(rms=rms)

        nov_next = self.novelty(state.net, self.encode(next_obs))
        if self.normalize:
            r2 = rs.update(rs.update(rms, nov), nov_next)
            rms = rs.where(warm, r2, rms)
            nov = torch.where(warm, rs.normalize(rms, nov), nov)
            nov_next = torch.where(warm, rs.normalize(rms, nov_next),
                                   nov_next)
        r = self.scale * torch.clamp(nov_next - 0.5 * nov, min=0.0)
        if self.depth_scale > 0.0:
            depth = torch.linalg.vector_norm(next_obs[:, :self.pos_dim],
                                             dim=-1)
            r = r * (1.0 + self.depth_scale * depth)
        return r[:, None], state._replace(rms=rms)

    def update(self, state: IntrinsicState, obs):
        """One predictor MSE step on the encoded obs, in place. Returns
        (new state, loss, pre-clip grad norm)."""
        pred, tgt = state.net(self.encode(obs))
        loss = torch.mean((pred - tgt) ** 2)
        params = state.net.params()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        gnorm = optim.apply_update(params, grads, state.opt_state, self.spec)
        return (state._replace(update_step=state.update_step + 1),
                loss.detach(), gnorm)
