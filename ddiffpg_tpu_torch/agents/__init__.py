"""Agents of the port: DDiffPG (acting, training, reclustering, eval).

`make_agent` mirrors `ddiffpg_tpu.agents.make_agent`; the baselines (TD3,
SAC, DIPO, DiffQ) are not ported yet.
"""

from __future__ import annotations


def make_agent(name: str, env, cfg, device="cuda", generator=None):
    """The agent `name` for `env` and `cfg`, on the card unless
    `device="cpu"`."""
    name = name.replace("Agent", "")
    if name == "DDiffPG":
        from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG
        return AgentDDiffPG(env, cfg, device=device, generator=generator)
    if name in ("TD3", "SAC", "DIPO", "DiffQ"):
        raise NotImplementedError(
            f"agent {name!r} is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError(f"unknown agent {name!r}")
