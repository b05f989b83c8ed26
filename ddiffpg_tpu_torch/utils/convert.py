"""The JAX package's parameters and train states, as numpy, into the port.

Takes numpy only (convert a JAX tree with `jax.tree.map(np.asarray, ...)`
where JAX is at hand), so loading needs no JAX. Flax `Dense` kernels are
[in, out]; `nn.Linear.weight` is [out, in], while the stacked critics keep
flax's [in, out] with leading [G_max, 2] (group, head) axes. optax's
`ScaleByAdamState` (mu, nu, count) is found by its fields wherever it sits
in a chain's state tuple.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

N_DENSE = 6
RND_LAYERS = ("512", "256", "128", "out")


def _t(x, dtype=None, device="cpu") -> torch.Tensor:
    a = np.array(x, dtype=dtype, copy=True)
    return torch.from_numpy(a).to(device)


def _params(tree: Mapping) -> Mapping:
    return tree.get("params", tree)


def actor_arrays(flax_params: Mapping) -> list:
    """A `DiffusionPolicy` tree ({'params': {'net': {'Dense_0'..}}}, the
    'params' level optional) -> arrays in the order of the port's
    `DiffusionPolicy.parameters()`."""
    net = _params(flax_params)["net"]
    out = []
    for i in range(N_DENSE):
        out += [np.asarray(net[f"Dense_{i}"]["kernel"], np.float32).T,
                np.asarray(net[f"Dense_{i}"]["bias"], np.float32)]
    return out


def critic_arrays(flax_params: Mapping) -> list:
    """A stacked `DistributionalDoubleQ` tree (leaves [G_max, ...]) ->
    arrays in the order of `models.mlp.DistributionalDoubleQ.params()`:
    the weights [G_max, 2, in, out], then the biases [G_max, 2, out]."""
    p = _params(flax_params)
    n = len(p["q1"])
    def stack(leaf):
        return [np.stack([np.asarray(p[h][f"Dense_{i}"][leaf], np.float32)
                          for h in ("q1", "q2")], axis=1) for i in range(n)]

    return stack("kernel") + stack("bias")


def rnd_arrays(flax_params: Mapping) -> list:
    """An `RNDModel` tree -> arrays in the order of the port's
    `RNDModel.params()` (predictor layers, then target layers)."""
    p = _params(flax_params)
    out = []
    for branch in ("pred", "tgt"):
        for w in RND_LAYERS:
            layer = p[f"{branch}_{w}"]
            out += [np.asarray(layer["kernel"], np.float32).T,
                    np.asarray(layer["bias"], np.float32)]
    return out


def dense_arrays(layers: Mapping) -> list:
    """Flax `Dense_0..` layers -> [weight [out, in], bias] arrays in the
    order of an `nn.ModuleList` of `nn.Linear`s' parameters."""
    out = []
    for i in range(len(layers)):
        out += [np.asarray(layers[f"Dense_{i}"]["kernel"], np.float32).T,
                np.asarray(layers[f"Dense_{i}"]["bias"], np.float32)]
    return out


def mlp_policy_arrays(flax_params: Mapping) -> list:
    """A `TanhMLPPolicy` or `TanhDiagGaussianMLPPolicy` tree -> arrays in
    the order of the port's module's `parameters()`."""
    return dense_arrays(_params(flax_params)["MLPNet_0"])


def double_q_arrays(flax_params: Mapping) -> list:
    """A `DoubleQ` tree -> arrays in the order of the port's `DoubleQ`
    `parameters()` (q1's layers, then q2's)."""
    p = _params(flax_params)
    return dense_arrays(p["q1"]) + dense_arrays(p["q2"])


def baseline_diffusion_arrays(flax_params: Mapping) -> list:
    """A baseline `Diffusion` tree -> arrays in the order of the port's
    `models.baseline_diffusion.Diffusion.parameters()`."""
    return dense_arrays(_params(flax_params)["model"])


def diag_gaussian_arrays(flax_params: Mapping) -> list:
    """A `DiagGaussianMLPPolicy` tree -> `logstd`, then its MLP's arrays
    (`parameters()` gives a module's own parameter before its
    submodules')."""
    p = _params(flax_params)
    return [np.asarray(p["logstd"], np.float32)] + dense_arrays(p["MLPNet_0"])


def ensemble_arrays(flax_params: Mapping, prefix: str) -> list:
    """An ensemble of MLPs named `<prefix>0`, `<prefix>1`, ... (q for
    `DistributionalEnsembleQ`, dyn for `DynamicModel`) -> their arrays,
    member after member."""
    p = _params(flax_params)
    return [a for i in range(len(p)) for a in dense_arrays(p[f"{prefix}{i}"])]


def mlp_resnet_arrays(flax_params: Mapping) -> list:
    """An `MLPResNet` tree -> arrays in the order of the port's
    `MLPResNet.parameters()`: the input layer, each block's LayerNorm
    (scale, bias) and two layers, the output layer."""
    p = _params(flax_params)
    blocks = sorted((k for k in p if k.startswith("MLPResNetBlock_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    out = dense_arrays({"Dense_0": p["Dense_0"]})
    for b in blocks:
        ln = p[b]["LayerNorm_0"]
        out += [np.asarray(ln["scale"], np.float32),
                np.asarray(ln["bias"], np.float32)]
        out += dense_arrays({k: p[b][k] for k in ("Dense_0", "Dense_1")})
    return out + dense_arrays({"Dense_0": p["Dense_1"]})


def model_arrays(name: str, flax_params: Mapping) -> list:
    """The flax tree of the JAX registry's model `name` -> arrays in the
    order of the port's `get_model(name)` module's `parameters()` (the
    stacked `DistributionalDoubleQ` in its `params()` order). The
    `EBMDiffusionPolicy` is laid out as `DiffusionPolicy`, `Consistency`
    as the baseline `Diffusion` (both keep their MLP under `net` and
    `model`)."""
    fns = {
        "MLPNet": lambda p: dense_arrays(_params(p)),
        "TanhMLPPolicy": mlp_policy_arrays,
        "TanhDiagGaussianMLPPolicy": mlp_policy_arrays,
        "DiagGaussianMLPPolicy": diag_gaussian_arrays,
        "MLPCritic": mlp_policy_arrays,
        "DoubleQ": double_q_arrays,
        "DistributionalDoubleQ": one_row_critic_arrays,
        "DistributionalEnsembleQ": lambda p: ensemble_arrays(p, "q"),
        "DynamicModel": lambda p: ensemble_arrays(p, "dyn"),
        "RNDModel": rnd_arrays,
        "DiffusionNet": lambda p: dense_arrays(_params(p)),
        "MLPResNet": mlp_resnet_arrays,
        "DiffusionPolicy": actor_arrays,
        "EBMDiffusionPolicy": actor_arrays,
        "BaselineMLP": lambda p: dense_arrays(_params(p)),
        "Diffusion": baseline_diffusion_arrays,
        "Consistency": baseline_diffusion_arrays,
    }
    if name not in fns:
        raise KeyError(f"no conversion for {name!r}")
    return fns[name](flax_params)


def _lead(tree):
    """Every leaf of a nested mapping with a leading axis of 1."""
    if isinstance(tree, Mapping):
        return {k: _lead(v) for k, v in tree.items()}
    return np.asarray(tree)[None]


def one_row_critic_arrays(flax_params: Mapping) -> list:
    """A single (unstacked) `DistributionalDoubleQ` tree, the TD3 and DIPO
    critic -> arrays of the port's critic at one row."""
    return critic_arrays(_lead(_params(flax_params)))


def find_adam(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    if all(hasattr(opt_state, f) for f in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = find_adam(s)
            if found is not None:
                return found
    return None


def adam_state(opt_state, arrays_fn, device="cpu"):
    """optax state -> the port's `ops.optim.AdamState`, with mu and nu laid
    out by `arrays_fn` (one of the functions above)."""
    from ddiffpg_tpu_torch.ops.optim import AdamState

    s = find_adam(opt_state)
    return AdamState(mu=[_t(x, device=device) for x in arrays_fn(s.mu)],
                     nu=[_t(x, device=device) for x in arrays_fn(s.nu)],
                     count=_t(s.count, np.int32, device))


@torch.no_grad()
def load_params(params, arrays):
    """Copy arrays into the port's parameter tensors, checking shapes."""
    params = list(params)
    if len(params) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for {len(params)} tensors")
    for p, a in zip(params, arrays):
        if tuple(p.shape) != tuple(a.shape):
            raise ValueError(f"shape {tuple(a.shape)} for {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, copy=True)))


def diffusion_state_dict(flax_params: Mapping) -> dict:
    """A `DiffusionPolicy` flax tree -> the state dict of the port's
    `DiffusionPolicy`."""
    arrays = actor_arrays(flax_params)
    sd = {}
    for i in range(N_DENSE):
        sd[f"net.dense.{i}.weight"] = torch.from_numpy(arrays[2 * i].copy())
        sd[f"net.dense.{i}.bias"] = torch.from_numpy(arrays[2 * i + 1].copy())
    return sd


def load_diffusion(policy: torch.nn.Module, flax_params: Mapping):
    """Copy the JAX package's DiffusionPolicy weights into `policy`."""
    policy.load_state_dict(diffusion_state_dict(flax_params))
    return policy


def _stats(st, dev):
    from ddiffpg_tpu_torch.agents.base import EpisodeStats, Tracker

    def tracker(tr):
        return Tracker(_t(tr.buf, np.float32, dev), _t(tr.ptr, np.int32, dev))

    return EpisodeStats(_t(st.current_returns, np.float32, dev),
                        _t(st.current_lengths, np.float32, dev),
                        tracker(st.return_tracker), tracker(st.step_tracker))


def _rms(rms, dev):
    from ddiffpg_tpu_torch.ops.running_stats import RunningMeanStd

    if rms is None:
        return None
    return RunningMeanStd(*(_t(x, np.float32, dev) for x in rms))


def _env_state(es, dev):
    from ddiffpg_tpu_torch.envs.base import EnvState

    return EnvState(_t(es.qpos, np.float32, dev),
                    _t(es.qvel, np.float32, dev), _t(es.t, np.int32, dev))


def _intrinsic(like, ji, dev):
    """The JAX intrinsic state into the port's `like`'s RND net."""
    from ddiffpg_tpu_torch.intrinsic import IntrinsicState

    load_params(like.net.params(), rnd_arrays(ji.params))
    return IntrinsicState(
        net=like.net, opt_state=adam_state(ji.opt_state, rnd_arrays, dev),
        rms=_rms(ji.rms, dev), update_step=_t(ji.update_step, np.int32, dev))


def _named(cls, src, like, dev):
    """A NamedTuple of tensors from the JAX one's numpy fields, in the
    dtypes of the port's `like`."""
    return cls(**{f: _t(getattr(src, f), device=dev).to(
        getattr(like, f).dtype) for f in cls._fields})


def ddiffpg_state(agent, jstate, env_state=None):
    """A JAX `DDiffPGState` with numpy leaves -> the port's DDiffPGState
    for `agent` (an `agents.ddiffpg.AgentDDiffPG`), on the agent's device.

    Carried across: the actor, the stacked critics and targets, the adam
    states of the actor, the critics (per row) and RND, the embeddings,
    the intrinsic state, the replay tables, the episode stats, the density
    grid (its leading device axis dropped), the obs, `global_step` and
    `obs_rms`. The JAX env state holds per-env PRNG keys the port has no
    use for; its qpos, qvel and t are taken unless `env_state` is given.
    """
    from ddiffpg_tpu_torch.replay.episodic import EpisodicReplay

    dev = agent.device
    ts = agent.init()
    load_params(ts.actor.parameters(), actor_arrays(jstate.actor_params))
    load_params(ts.critics.params(), critic_arrays(jstate.critics))
    load_params(ts.critic_targets.params(),
                critic_arrays(jstate.critic_targets))
    ts.actor_opt = adam_state(jstate.actor_opt, actor_arrays, dev)
    ts.critic_opts = adam_state(jstate.critic_opts, critic_arrays, dev)
    ts.embeddings = _t(jstate.embeddings, np.float32, dev)
    ts.intrinsic = _intrinsic(ts.intrinsic, jstate.intrinsic, dev)
    ts.replay = _named(EpisodicReplay, jstate.replay, ts.replay, dev)
    ts.env_state = env_state or _env_state(jstate.env_state, dev)
    ts.obs = _t(jstate.obs, np.float32, dev)
    ts.stats = _stats(jstate.stats, dev)
    ts.global_step = _t(jstate.global_step, np.int64, dev)
    ts.density_grid = _t(np.asarray(jstate.density_grid)[0], np.int32, dev)
    ts.obs_rms = _rms(jstate.obs_rms, dev)
    return ts


def td3_state(agent, jstate, env_state=None):
    """A JAX `TD3State` with numpy leaves (TD3's, DIPO's or DiffQ's) ->
    the port's `TD3State` for `agent` (an `agents.td3.AgentTD3` or a
    subclass), on the agent's device: the actor and the critic with their
    targets and adam states, the intrinsic state, the flat replay, the
    n-step window, the env state (qpos, qvel, t unless `env_state` is
    given), obs, the episode stats, `global_step` and `obs_rms`. The
    actor's layout follows the agent: an MLP policy, DIPO's DDPM policy
    or DiffQ's baseline `Diffusion`."""
    from ddiffpg_tpu_torch.agents.diffq import AgentDiffQ
    from ddiffpg_tpu_torch.agents.dipo import AgentDIPO
    from ddiffpg_tpu_torch.agents.sac import AgentSAC
    from ddiffpg_tpu_torch.ops.nstep import NStepState
    from ddiffpg_tpu_torch.replay.flat import FlatReplay

    dev = agent.device
    if isinstance(agent, AgentDiffQ):
        actor_fn = baseline_diffusion_arrays
    elif isinstance(agent, AgentDIPO):
        actor_fn = actor_arrays
    else:
        actor_fn = mlp_policy_arrays
    critic_fn = (double_q_arrays if isinstance(agent, AgentSAC)
                 else one_row_critic_arrays)
    ts = agent.init()
    for mod, tree in ((ts.actor, jstate.actor_params),
                      (ts.actor_target, jstate.actor_target)):
        load_params(mod.parameters(), actor_fn(tree))
    for mod, tree in ((ts.critic, jstate.critic_params),
                      (ts.critic_target, jstate.critic_target)):
        load_params(mod.params(), critic_fn(tree))
    ts.actor_opt = adam_state(jstate.actor_opt, actor_fn, dev)
    ts.critic_opt = adam_state(jstate.critic_opt, critic_fn, dev)
    ts.intrinsic = _intrinsic(ts.intrinsic, jstate.intrinsic, dev)
    ts.replay = _named(FlatReplay, jstate.replay, ts.replay, dev)
    ts.nstep = _named(NStepState, jstate.nstep, ts.nstep, dev)
    ts.env_state = env_state or _env_state(jstate.env_state, dev)
    ts.obs = _t(jstate.obs, np.float32, dev)
    ts.stats = _stats(jstate.stats, dev)
    ts.global_step = _t(jstate.global_step, np.int64, dev)
    ts.obs_rms = _rms(jstate.obs_rms, dev)
    return ts


def sac_state(agent, jstate, env_state=None):
    """A JAX `SACState` with numpy leaves -> the port's `SACState` for
    `agent` (an `agents.sac.AgentSAC`): the JAX state's `core` as
    `td3_state` reads it, `log_alpha` and alpha's adam state."""
    dev = agent.device
    scalar = lambda x: [np.asarray(x, np.float32)]  # noqa: E731
    ts = td3_state(agent, jstate.core, env_state)
    ts.log_alpha = _t(jstate.log_alpha, np.float32, dev)
    ts.alpha_opt = adam_state(jstate.alpha_opt, scalar, dev)
    return ts


def cluster_state(cm, jcm):
    """A JAX `ClusterManager`'s host state -> the port's `cm` (a
    `modes.cluster.ClusterManager`): the DTW cache, the Q-scheduler's last
    clusters and the state of the sampling `random.Random`. Plain Python
    objects only, so this needs no JAX either."""
    cm.cache = dict(jcm.cache)
    cm.scheduler.last_cluster = [list(c) for c in jcm.scheduler.last_cluster]
    cm.rng.setstate(jcm.rng.getstate())
    return cm


def split_dp(tree, rank: int, world: int, axis: str = "data", path=()):
    """Rank `rank`'s share of a JAX data-parallel global state (numpy
    leaves; `ddiffpg_tpu/parallel/dp.py`'s layout): every leaf that
    `parallel/dp.py:leaf_spec` splits is cut into `world` equal parts
    along its split axis and part `rank` kept; the rest is replicated and
    kept whole. The result is the JAX local state that
    `DPAgentDDiffPG.init` concatenated, for `ddiffpg_state`."""
    from ddiffpg_tpu_torch.parallel.dp import leaf_spec

    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[split_dp(getattr(tree, f), rank, world, axis,
                                     path + (f,)) for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(split_dp(v, rank, world, axis, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, Mapping):
        return {k: split_dp(v, rank, world, axis, path + (k,))
                for k, v in tree.items()}
    spec = leaf_spec(path, axis)
    if not spec:
        return tree
    arr = np.asarray(tree)
    ax = spec.index(axis)
    n = arr.shape[ax] // world
    return np.take(arr, np.arange(rank * n, (rank + 1) * n), axis=ax)
