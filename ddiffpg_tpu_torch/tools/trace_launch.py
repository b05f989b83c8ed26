"""Deterministic repro and substep forensics of a launch event.

    python -m ddiffpg_tpu_torch.tools.trace_launch CKPT [env=antmaze-v1]
        [eval_envs=40] [seed=7] [env_id=] [vxy_jump=5.0] [num_envs=256]
        [save=] [device=auto]

Counterpart of the root `tools/trace_launch.py`. Replays an eval rollout
of the checkpoint's eval policy (`eval_envs` ants from random starts, one
episode length, on `physics/engine_cl.py` with the maze's SDF walls, as
the JAX tool's `use_pallas=False` env), keeps every control step's (qpos,
qvel, action) of every env (`save=` writes them as `[T, E, ...]` arrays
to an .npz), picks the env with the largest planar speed (or `env_id`),
finds its first control step whose planar COM speed jumps by more than
`vxy_jump`, and prints the steps around it. Then it re-simulates that
step substep by substep with the contact diagnostics of each substep: the
deepest floor and wall penetrations, the summed vertical contact force
and the largest horizontal one. The JAX tool does this on its per-env
engine, which tests the wall AABBs; here `engine_cl` does it on one env
of the model with its SDF left out, so that the AABB walls are tested
(`tests/test_engine_cl.py` holds the two JAX engines within 2e-5 / 2e-4).
`num_envs` and any dotted override must be the run's.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ddiffpg_tpu_torch.physics.engine_cl import Engine
from ddiffpg_tpu_torch.tools import common


def box_engine(m, device) -> Engine:
    """`engine_cl` of the model with its SDF left out: AABB walls."""
    return Engine(dataclasses.replace(
        m, sdf_dist=np.zeros((0, 0), np.float32),
        sdf_grad=np.zeros((0, 0, 2), np.float32)), device)


@torch.no_grad()
def diagnostics(eng: Engine, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
    """The JAX tool's contact diagnostics of one state (qpos [nq], qvel
    [nv]) in world-origin coordinates: the deepest floor and wall
    penetrations, the summed vertical contact force, the largest
    horizontal one."""
    body_pos, body_quat = eng.fk(qpos[None])
    S = eng.kin.dof_subspaces(body_pos, body_quat)
    V = eng.body_velocities(S, eng.kin.qvel_to_u(qvel[None], body_pos))
    d = {}
    F = eng.contact_forces(body_pos, body_quat, V, diag=d)[0]
    out = {"pen_floor_max": float(d["pen_floor"].max())}
    if eng.nsb:
        out["pen_wall_max"] = float(d["pen_wall"].max())
    out["Fz_sum"] = float(F[:, 5].sum())
    out["Fxy_max"] = float(F[:, 3:5].abs().max())
    return out


@torch.no_grad()
def rollout(env, actor_fn) -> dict:
    """One episode length of `env` from a reset: the state each action
    was taken in, the action and done, stacked [T, E, ...] as numpy."""
    state, obs = env.reset()
    rec = {"qpos": [], "qvel": [], "act": [], "done": []}
    for _ in range(env.max_episode_length):
        act = actor_fn(obs)
        rec["qpos"].append(state.qpos)
        rec["qvel"].append(state.qvel)
        rec["act"].append(act)
        state, obs, _, done, _ = env.step(state, act)
        rec["done"].append(done)
    return {k: torch.stack(v).cpu().numpy() for k, v in rec.items()}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env="antmaze-v1", eval_envs="40",
                            seed="7", env_id="", vxy_jump="5.0",
                            num_envs="256", save="")
    cfg, agent, ts, _ = common.load(argv[0], kw, over)
    seed, vxy_jump = int(kw["seed"]), float(kw["vxy_jump"])
    env = common.eval_env(cfg, int(kw["eval_envs"]), seed, random_init=True)
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    tr = rollout(env, lambda obs: agent.eval_actor(ts, obs, generator=gen))
    qpos, qvel, acts = tr["qpos"], tr["qvel"], tr["act"]
    T = qpos.shape[0]
    if kw["save"]:
        np.savez_compressed(kw["save"], **tr)
        print(f"saved trajectory -> {kw['save']}")

    # the worst planar-speed jump across envs and steps
    vxy = np.linalg.norm(qvel[:, :, :2], axis=-1)          # [T, E]
    e = int(kw["env_id"]) if kw["env_id"] else int(
        np.unravel_index(np.argmax(vxy), vxy.shape)[1])
    v_e = vxy[:, e]
    jumps = np.where(np.diff(v_e) > vxy_jump)[0]
    t0 = int(jumps[0]) if len(jumps) else max(int(np.argmax(v_e)) - 1, 0)
    print(f"env {e}: max |vxy| {v_e.max():.2f} at t={int(np.argmax(v_e))}; "
          f"first jump >{vxy_jump} m/s at t={t0} "
          f"({v_e[t0]:.2f} -> {v_e[min(t0 + 1, T - 1)]:.2f})")
    for t in range(max(t0 - 3, 0), min(t0 + 3, T)):
        print(f"  t={t:4d} xy=({qpos[t, e, 0]:7.2f},{qpos[t, e, 1]:7.2f}) "
              f"z={qpos[t, e, 2]:6.3f} |vxy|={v_e[t]:7.2f} "
              f"vz={qvel[t, e, 2]:7.2f} "
              f"|w|={np.linalg.norm(qvel[t, e, 3:6]):6.2f} "
              f"|qd|max={np.abs(qvel[t, e, 6:]).max():6.2f}")

    # substep forensics of the jump step, on the AABB walls
    eng = box_engine(env.env.model, agent.device)
    dev = agent.device
    qp = torch.as_tensor(qpos[t0, e], device=dev)
    qv = torch.as_tensor(qvel[t0, e], device=dev)
    ctrl = torch.as_tensor(acts[t0, e], device=dev)[None]
    n_sub = int(eng.m.n_substeps)
    print(f"substep forensics at t={t0} (dt={eng.dt}, {n_sub} substeps):")
    subs = []
    for s in range(n_sub):
        d = diagnostics(eng, qp, qv)
        subs.append(d)
        print(f"  s={s:2d} z={float(qp[2]):7.3f} "
              f"|vxy|={float(torch.linalg.vector_norm(qv[:2])):8.2f} "
              f"vz={float(qv[2]):8.2f} "
              + " ".join(f"{k}={v:10.2f}" for k, v in d.items()))
        a, b = eng.substep(qp[None], qv[None], ctrl)
        qp, qv = a[0], b[0]
        if not bool(torch.isfinite(qv).all()):
            print("  NaN/inf in qvel — stopping")
            break
    print(f"  end  z={float(qp[2]):7.3f} "
          f"|vxy|={float(torch.linalg.vector_norm(qv[:2])):8.2f} "
          f"vz={float(qv[2]):8.2f}")
    return {"env": e, "t0": t0, "vxy_max": float(v_e.max()),
            "substeps": subs}


if __name__ == "__main__":
    main()
