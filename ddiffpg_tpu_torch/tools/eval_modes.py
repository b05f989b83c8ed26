"""Per-mode conditioning forensics of a DDiffPG checkpoint: is the
distillation or the target actions' quality the problem?

    python -m ddiffpg_tpu_torch.tools.eval_modes CKPT [env=antmaze-v1]
        [num_envs=256] [eval_envs=40] [seed=11] [device=auto]

Counterpart of the root `tools/eval_modes.py`, on a full checkpoint
written by `train.main` (`num_envs` and any dotted override must be the
run's; a light checkpoint has no replay and is refused):

  1. Eval success per conditioning: the zero embedding (the eval policy),
     the explore embedding and each live mode's, then the zero and
     explore embeddings with the training path's mixed exploration noise
     (`ops/noise.py`), which tells a noise-carried success from a
     policy-carried one.
  2. Per group, on 512 transitions from `replay/episodic.py:sample_group`:
     the mean Q_g of (a) the behaviour action stored in the replay, (b)
     the improved target action, (c) the actor's action under the group's
     embedding, (d) the actor's action under the zero embedding. (b) >>
     (c): the actor lags the distillation; (b) ~ (a): the action gradient
     is weak. Group 0 decodes on the explore critic's own support.

The rollouts step `physics/engine_cl.py` (`use_pallas=False`), as the
JAX tool's do, on the card (`device=auto`, the default; it raises without
one) or on the CPU (`device=cpu`).
"""

from __future__ import annotations

import sys

import torch

from ddiffpg_tpu_torch.agents.evaluation import eval_rollout
from ddiffpg_tpu_torch.replay import episodic as ep
from ddiffpg_tpu_torch.tools import common

BATCH = 512


def group_q(agent, ts, g: int, generator) -> dict:
    """Group g's mean Q of the behaviour, target, actor|emb and actor|0
    actions on BATCH sampled transitions, the mean |target - behaviour|
    and how many samples came from stored trajectories."""
    gb = ep.sample_group(ts.replay, g, BATCH, mix_temp=False,
                         generator=generator)
    zero = torch.zeros(agent.embed_dim, device=agent.device)
    act_mode = common.actor_with(agent, ts, ts.embeddings[g],
                                 generator)(gb.obs)
    act_zero = common.actor_with(agent, ts, zero, generator)(gb.obs)
    q = lambda act: float(common.q_of(agent, ts, g, gb.obs,  # noqa: E731
                                      act).mean())
    return {"behavior": q(gb.action), "target_act": q(gb.target_action),
            "actor_emb": q(act_mode), "actor_zero": q(act_zero),
            "tgt_minus_beh": float((gb.target_action - gb.action).abs()
                                   .mean()),
            "real": int(gb.from_buffer.sum())}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    kw, over = common.parse(argv[1:], env="antmaze-v1", num_envs="256",
                            eval_envs="40", seed="11")
    path = argv[0]
    cfg, agent, ts, meta = common.load(path, kw, over)
    if meta.get("light"):
        raise SystemExit(f"{path} is a light checkpoint: eval_modes samples "
                         "the replay, which it leaves out; give it a full "
                         "one (ckpt_final.pt)")
    G = int(meta.get("num_groups", 1))
    print(f"num_groups={G} global_step={int(ts.global_step)}")
    seed = int(kw["seed"])
    env = common.eval_env(cfg, int(kw["eval_envs"]), seed, random_init=True)
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    noise = (cfg.algo.noise.std_min, cfg.algo.noise.std_max)
    conds = common.conditionings(agent, ts, G)
    runs = [(name, emb, None) for name, emb in conds] + [
        (name + "+nz", emb, noise) for name, emb in conds[:2]]
    evals = {}
    for name, emb, nz in runs:
        m, _ = eval_rollout(env, common.actor_with(agent, ts, emb, gen, nz))
        evals[name] = m
        print(f"  eval[{name:8s}]: success={m['eval/success_rate']:.3f} "
              f"return={m['eval/return']:.2f} "
              f"len={m['eval/episode_length']:.0f} "
              f"episodes={int(m['eval/episodes'])}")
    print(f"per-group Q_g comparison on {BATCH} replayed transitions:")
    groups = []
    for g in range(G):
        r = group_q(agent, ts, g, gen)
        groups.append(r)
        print(f"  g={g}: Q(behavior)={r['behavior']:7.3f} "
              f"Q(target_act)={r['target_act']:7.3f} "
              f"Q(actor|emb)={r['actor_emb']:7.3f} "
              f"Q(actor|0)={r['actor_zero']:7.3f} "
              f"|tgt-beh|={r['tgt_minus_beh']:.3f} real={r['real']}/{BATCH}")
    return {"num_groups": G, "success": {k: m["eval/success_rate"]
                                         for k, m in evals.items()},
            "groups": groups}


if __name__ == "__main__":
    main()
