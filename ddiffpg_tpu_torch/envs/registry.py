"""Env registry (counterpart of `ddiffpg_tpu/envs/registry.py`)."""

from __future__ import annotations

from ddiffpg_tpu_torch.envs.base import VecEnv


def make(name: str, num_envs: int = 1, **kwargs) -> VecEnv:
    if name == "antmaze-v1":
        from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
        env = AntMazeEnv(name=name, **kwargs)
    elif name.startswith("Panda"):
        from ddiffpg_tpu_torch.envs.panda import make_panda_env
        env = make_panda_env(name, **kwargs)
    elif name.startswith(("antmaze", "pointmaze")):
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP.md, Queue 1: the other "
            "mazes and pointmaze)")
    else:
        raise ValueError(f"unknown env {name!r}")
    return VecEnv(env, num_envs)
