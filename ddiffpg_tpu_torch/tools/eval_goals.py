"""Offline per-goal evaluation of a checkpoint, for any env.

    python -m ddiffpg_tpu_torch.tools.eval_goals CKPT env=<name>
        [algo=ddiffpg] [num_envs=256] [eval_envs=40] [seeds=3] [device=auto]

Counterpart of the root `tools/eval_goals.py`: the in-run eval
(`agents/evaluation.py:eval_rollout`, which carries the per-goal success
breakdown) of the agent's eval policy, `seeds` times (actor draws seeded
100, 101, ...), on a full or light checkpoint written by `train.main`
(`num_envs` and any dotted override must be the run's). Prints one JSON
line per seed and a summary weighted by each seed's episodes. The ant and
Panda rollouts step `physics/engine_cl.py` (`use_pallas=False`), as the
JAX tool's do, on the card (`device=auto`, the default; it raises without
one) or on the CPU (`device=cpu`). Pointmaze has no engine: the JAX tool
raises on its names (its env takes no `use_pallas`), this one runs them.
"""

from __future__ import annotations

import json
import math
import sys

import torch

from ddiffpg_tpu_torch.agents.evaluation import eval_rollout
from ddiffpg_tpu_torch.tools import common


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env=None, algo="ddiffpg",
                            num_envs="256", eval_envs="40", seeds="3")
    if kw["env"] is None:
        raise SystemExit("eval_goals needs env=<name>")
    path = argv[0]
    cfg, agent, ts, _ = common.load(path, kw, over)
    env = common.eval_env(cfg, int(kw["eval_envs"]), 100, random_init=False)
    agg: dict[str, float] = {}
    n_ep = 0.0
    for s in range(int(kw["seeds"])):
        gen = torch.Generator(device=agent.device).manual_seed(100 + s)
        m, _ = eval_rollout(
            env, lambda obs: agent.eval_actor(ts, obs, generator=gen))
        w = m["eval/episodes"]
        n_ep += w
        for k, v in m.items():
            if k != "eval/episodes":
                agg[k] = agg.get(k, 0.0) + v * w
        print(json.dumps({"seed": 100 + s,
                          **{k: round(v, 4) for k, v in m.items()}}),
              flush=True)
    summary = {k: round(v / max(n_ep, 1.0), 4) for k, v in agg.items()}
    summary["eval/episodes"] = n_ep
    print(json.dumps({"summary": summary, "ckpt": str(path),
                      "step": int(ts.global_step)}), flush=True)
    if not all(math.isfinite(v) for v in summary.values()):
        raise RuntimeError(f"non-finite eval metrics: {summary}")
    return summary


if __name__ == "__main__":
    main()
