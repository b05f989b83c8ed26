"""Agents of the port: DDiffPG (acting, training, reclustering, eval) and
the baselines TD3, SAC, DIPO and DiffQ.

`make_agent` mirrors `ddiffpg_tpu.agents.make_agent`.
"""

from __future__ import annotations


def make_agent(name: str, env, cfg, device="cuda", generator=None):
    """The agent `name` for `env` and `cfg`, on the card unless
    `device="cpu"`."""
    from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG
    from ddiffpg_tpu_torch.agents.diffq import AgentDiffQ
    from ddiffpg_tpu_torch.agents.dipo import AgentDIPO
    from ddiffpg_tpu_torch.agents.sac import AgentSAC
    from ddiffpg_tpu_torch.agents.td3 import AgentTD3

    agents = {"TD3": AgentTD3, "SAC": AgentSAC, "DIPO": AgentDIPO,
              "DDiffPG": AgentDDiffPG, "DiffQ": AgentDiffQ}
    name = name.replace("Agent", "")
    if name not in agents:
        raise ValueError(f"unknown agent {name!r}")
    return agents[name](env, cfg, device=device, generator=generator)
