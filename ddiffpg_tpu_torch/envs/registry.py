"""Env registry (counterpart of `ddiffpg_tpu/envs/registry.py`): every
`antmaze-*` and `pointmaze-*` name of `physics/maze.py:MAZES`, and
`Panda{Reach,PegInsertion,DrawerMulti,Cabinet}[Joints][Dense][Random]-v3`."""

from __future__ import annotations

from ddiffpg_tpu_torch.envs.base import VecEnv


def make(name: str, num_envs: int = 1, **kwargs) -> VecEnv:
    if name.startswith("antmaze"):
        from ddiffpg_tpu_torch.envs.antmaze import AntMazeEnv
        env = AntMazeEnv(name=name, **kwargs)
    elif name.startswith("pointmaze"):
        from ddiffpg_tpu_torch.envs.pointmass import PointMazeEnv
        env = PointMazeEnv(name=name, **kwargs)
    elif name.startswith("Panda"):
        from ddiffpg_tpu_torch.envs.panda import make_panda_env
        env = make_panda_env(name, **kwargs)
    else:
        raise ValueError(f"unknown env {name!r}")
    return VecEnv(env, num_envs)
