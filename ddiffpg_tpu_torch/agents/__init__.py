"""Agents of the port: DDiffPG (acting, training, reclustering, eval) and
the baselines TD3, SAC, DIPO and DiffQ.

`AGENTS` and `make_agent` mirror `ddiffpg_tpu.agents`. The agents' modules
are imported at the first use of either (`AGENTS` is built by the module's
`__getattr__`), not when the package is.
"""

from __future__ import annotations


def __getattr__(name: str):
    if name != "AGENTS":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG
    from ddiffpg_tpu_torch.agents.diffq import AgentDiffQ
    from ddiffpg_tpu_torch.agents.dipo import AgentDIPO
    from ddiffpg_tpu_torch.agents.sac import AgentSAC
    from ddiffpg_tpu_torch.agents.td3 import AgentTD3

    agents = {"TD3": AgentTD3, "SAC": AgentSAC, "DIPO": AgentDIPO,
              "DDiffPG": AgentDDiffPG, "DiffQ": AgentDiffQ}
    globals()["AGENTS"] = agents
    return agents


def make_agent(name: str, env, cfg, device="cuda", generator=None):
    """The agent `name` for `env` and `cfg`, on the card unless
    `device="cpu"`."""
    agents = globals().get("AGENTS") or __getattr__("AGENTS")
    name = name.replace("Agent", "")
    if name not in agents:
        raise ValueError(f"unknown agent {name!r}")
    return agents[name](env, cfg, device=device, generator=generator)
