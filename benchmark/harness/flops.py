"""Model FLOPs of DDiffPG's steps, from a configuration's widths.

Frozen in the benchmark, so that no change to the program moves it. A
matrix product of n rows through a layer in -> out counts 2 n in out
FLOPs forward; a backward pass for the weights and the input counts twice
the forward, one for the input alone once the forward. Elementwise work
(activations, softmax, the DDPM arithmetic, Adam) is not counted.
"""

from __future__ import annotations


def _macs(widths) -> int:
    return sum(a * b for a, b in zip(widths, widths[1:]))


def actor_macs(w: dict) -> int:
    """Multiply-adds of one row through the noise-prediction net (one
    denoise step): the time MLP, then the trunk on [time emb, obs,
    embedding, action] -> action."""
    t = w["actor_time_mlp"]
    trunk_in = t[-1] + w["obs_dim"] + w["embedding_dim"] + w["action_dim"]
    return _macs(t) + _macs([trunk_in, *w["actor_trunk"], w["action_dim"]])


def critic_macs(w: dict) -> int:
    """One row of one group through both heads of the C51 critic."""
    return 2 * _macs([w["obs_dim"] + w["action_dim"], *w["critic_hidden"],
                      w["num_atoms"]])


def rnd_net_macs(w: dict) -> int:
    """One row through one RND net (the predictor or the target), on the
    obs with its position channels' NeRF encoding."""
    d = w["obs_dim"] + w["pos_dim"] * 2 * w["posenc_L"]
    return _macs([d, *w["rnd_hidden"], w["rnd_feat_dim"]])


def act_flops(w: dict) -> float:
    """One env step of the actor: the K-step reverse denoise of one row."""
    return 2.0 * w["diffusion_iter"] * actor_macs(w)


def update_pass_flops(w: dict, cfg: dict, groups: int) -> float:
    """One update pass at `groups` live groups of batch_size // groups."""
    a = cfg["algo"]
    b = a["batch_size"] // groups
    n = groups * b
    K = w["diffusion_iter"]
    act, crit, rnd = actor_macs(w), critic_macs(w), rnd_net_macs(w)
    steps = cfg["diffusion"]["update_times"]
    macs = (2 * n * 2 * rnd          # NovelD: both nets on obs, next obs
            + n * K * act            # target actions, K-step denoise
            + n * crit               # target critics on the next batch
            + 3 * n * crit           # critics forward and backward
            + steps * 2 * n * crit   # action gradient: forward, input grad
            + 3 * n * act            # actor loss forward and backward
            + 2 * n * (3 * rnd + rnd)  # RND update: predictor fwd+bwd, target
            + b * crit)              # the explore row's Q for the logs
    return 2.0 * macs


def train_iter_flops(w: dict, cfg: dict, num_envs: int, groups: int) -> float:
    a = cfg["algo"]
    return (a["horizon_len"] * num_envs * act_flops(w)
            + a["update_times"] * update_pass_flops(w, cfg, groups))
