"""DiffQ: DIPO with the self-contained baseline diffusion actor.

Counterpart of `ddiffpg_tpu/agents/diffq.py`: the actor is
`models/baseline_diffusion.py:Diffusion` with the `vp` beta schedule
instead of the main DDPM policy; everything else is DIPO's.
"""

from __future__ import annotations

from ddiffpg_tpu_torch.agents.dipo import AgentDIPO
from ddiffpg_tpu_torch.models.baseline_diffusion import Diffusion


class AgentDiffQ(AgentDIPO):
    name = "DiffQ"

    def _make_actor(self, g):
        return Diffusion(self.action_dim, self.obs_dim,
                         n_timesteps=self.cfg.diffusion.diffusion_iter,
                         beta_schedule="vp", device=self.device, generator=g)
