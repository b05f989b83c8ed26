"""Critic-field forensics of a DDiffPG checkpoint: is Q state-sensitive
and action-sensitive?

    python -m ddiffpg_tpu_torch.tools.probe_qfield CKPT [env=antmaze-v2]
        [num_envs=256] [line=-8.8,0:-8.8,8:5] [device=auto]

Counterpart of the root `tools/probe_qfield.py`. Plants the agent at `n`
points along the line x0,y0:x1,y1:n (the rest of the obs is a reset
env's) and reports, for each group's critic, the mean Q over 256 uniform
random actions, their spread (the action-sensitivity) and the mean Q of
the actor's zero-embedding actions. A healthy done-at-goal field rises
toward the goal and separates actions at the ~1% scale; a flat field
(spread ~1e-3) leaves the action-gradient improvement nothing to climb.
Group 0 decodes on the explore critic's own support. Takes a full or
light checkpoint written by `train.main` (`num_envs` and any dotted
override must be the run's); it steps no env.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ddiffpg_tpu_torch.tools import common

N_ACTIONS = 256


def parse_line(line: str):
    """"x0,y0:x1,y1:n" -> n points [n, 2] from (x0, y0) to (x1, y1)."""
    a, b, n = line.split(":")
    return np.linspace(tuple(map(float, a.split(","))),
                       tuple(map(float, b.split(","))), int(n))


def point_q(agent, ts, obs0: torch.Tensor, px: float, py: float,
            num_groups: int) -> list:
    """Per group: (mean Q of random actions, their spread, mean Q of the
    actor's actions) with the agent planted at (px, py)."""
    obs = obs0.clone()
    obs[0], obs[1] = px, py
    ob = obs[None].repeat(N_ACTIONS, 1)
    gen = torch.Generator(device=obs.device).manual_seed(
        hash((px, py)) % 2**31)
    zero = torch.zeros(agent.embed_dim, device=obs.device)
    a_act = common.actor_with(agent, ts, zero, gen)(ob)
    a_rnd = torch.rand((N_ACTIONS, agent.action_dim), generator=gen,
                       device=obs.device) * 2.0 - 1.0
    out = []
    for g in range(num_groups):
        qr = common.q_of(agent, ts, g, ob, a_rnd)
        out.append((float(qr.mean()), float(qr.std(correction=0)),
                    float(common.q_of(agent, ts, g, ob, a_act).mean())))
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env="antmaze-v2", num_envs="256",
                            line="-8.8,0:-8.8,8:5")
    cfg, agent, ts, meta = common.load(argv[0], kw, over)
    G = int(meta.get("num_groups", 1))
    print(f"num_groups={G}")
    _, obs0 = common.eval_env(cfg, 8, 0, random_init=False).reset()
    rows = {}
    for px, py in parse_line(kw["line"]):
        qs = point_q(agent, ts, obs0[0], float(px), float(py), G)
        rows[f"{px:.1f},{py:.1f}"] = qs
        print("  ".join([f"({px:5.1f},{py:5.1f})"] + [
            f"g{g}: Q={q:.3f} spread={s:.4f} actor={qa:.3f}"
            for g, (q, s, qa) in enumerate(qs)]))
    return rows


if __name__ == "__main__":
    main()
