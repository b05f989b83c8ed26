"""Energy-injection probe of the ant physics.

    python -m ddiffpg_tpu_torch.tools.probe_energy [steps=300] [envs=8]
        [device=auto]

Counterpart of the root `tools/probe_energy.py`: drives antmaze-v1 ants
from the fixed start with seven open-loop action patterns (constant +1
and -1, alternating hips and ankles, bang-bang at 1, 2.5 and 5 Hz of
control steps, uniform random) and reports the worst torso height,
vertical speed and hinge speed reached, the share of hinge speeds at the
qvel clamp and the episode ends. A sane ant with gear-30 motors tops out
near one body height; metres of altitude or hinge speeds pinned at the
clamp point at an energy leak. It steps `physics/engine_cl.py`
(`use_pallas=False`: the maze's SDF walls), as the JAX tool does, on the
card (`device=auto`, the default; it raises without one) or on the CPU
(`device=cpu`).
"""

from __future__ import annotations

import math
import sys

import torch

from ddiffpg_tpu_torch import train
from ddiffpg_tpu_torch.envs import make
from ddiffpg_tpu_torch.tools import common

PATTERNS = ("const+", "const-", "alternate", "bang1", "bang2.5", "bang5",
            "random")


def pattern(name: str, t: torch.Tensor, E: int, generator=None):
    """The actions [E, 8] of pattern `name` at control step t (a float32
    scalar tensor); "random" draws from `generator`."""
    dev = t.device
    if name == "const+":
        return torch.ones((E, 8), device=dev)
    if name == "const-":
        return -torch.ones((E, 8), device=dev)
    if name == "alternate":
        # opposing hips/ankles, the sign flipping per env to vary phase
        base = torch.tensor([1.0, -1.0], device=dev).repeat(4)
        env = torch.arange(E, dtype=torch.float32, device=dev)[:, None]
        return torch.sign(torch.sin(0.5 * t + env)) * base
    if name.startswith("bang"):
        hz = float(name[4:])
        return torch.sign(torch.sin(2 * math.pi * hz * 0.1 * t)) \
            * torch.ones((E, 8), device=dev)
    if name == "random":
        return torch.rand((E, 8), generator=generator, device=dev) * 2 - 1
    raise ValueError(name)


@torch.no_grad()
def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    kw, _ = common.parse(argv, steps="300", envs="8")
    T, E = int(kw["steps"]), int(kw["envs"])
    device = train.resolve_device(kw["device"])
    env = make("antmaze-v1", num_envs=E, random_init=False, device=device,
               use_pallas=False)
    out = {}
    for name in PATTERNS:
        gen = torch.Generator(device=device).manual_seed(0)
        state, obs = env.reset()
        z, vz, hs, dones = [], [], [], []
        for t in torch.arange(T, dtype=torch.float32, device=device):
            state, obs, _, done, _ = env.step(state,
                                              pattern(name, t, E, gen))
            # obs is pre-reset: z, vz and hinge speeds of the true state
            z.append(obs[:, 2])
            vz.append(obs[:, 17].abs())
            hs.append(obs[:, 21:29].abs().amax(-1))
            dones.append(done)
        z, vz, hs = torch.stack(z), torch.stack(vz), torch.stack(hs)
        r = {"z_max": float(z.max()), "vz_max": float(vz.max()),
             "hinge_max": float(hs.max()),
             "hinge_at_clamp": float((hs > 19.5).float().mean()),
             "dones": int(torch.stack(dones).sum())}
        out[name] = r
        print(f"{name:10s} z_max={r['z_max']:6.2f}  "
              f"vz_max={r['vz_max']:6.2f}  hinge_max={r['hinge_max']:6.2f}"
              f"  hinge@clamp={r['hinge_at_clamp']:.3f}  "
              f"dones={r['dones']}")
    return out


if __name__ == "__main__":
    main()
