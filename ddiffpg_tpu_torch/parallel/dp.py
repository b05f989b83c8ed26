"""Data-parallel DDiffPG over torch.distributed.

Counterpart of `ddiffpg_tpu/parallel/dp.py`. Layout (`state_specs`, the
JAX package's PartitionSpecs over the one `data` axis):
  * parameters, optimizer states, embeddings, the intrinsic state —
    replicated: the same bits on every rank;
  * the env batch (env_state, obs, the episode stats), the density grid
    and the episodic replay's slots — each rank's own share; the replay's
    `group_mask` and `target_action` along their slot axis (axis 1);
  * gradients — averaged across the ranks inside every optimizer update
    (`ops/optim.py:apply_update` under `agents/base.py:data_parallel`), as
    are `update_rms`'s batch moments and the logged density coverage, so
    every rank applies the same step. The action gradient's Adam on the
    sampled actions stays per rank, as in the JAX package.

Each rank runs one process: `DPAgentDDiffPG` builds the agent on a local
config (`num_envs`, `algo.memory_size` and `algo.batch_size` divided by
the world size) with the cluster manager's capacity at the global memory
size, and draws from generators seeded by (seed, rank), as the JAX
package folds the axis index into its key. The recluster sees the global
replay: `update_cluster` gathers the fields it reads from every rank,
reclusters on rank 0 and broadcasts its result (group masks, the
scheduler's plan, the evictions) and the fresh embeddings; each rank
keeps its slots' share.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ddiffpg_tpu_torch.agents import base
from ddiffpg_tpu_torch.agents.ddiffpg import AgentDDiffPG, DDiffPGState

SHARDED = ("env_state", "obs", "stats", "density_grid")
SLOT_AXIS_1 = ("group_mask", "target_action")


def leaf_spec(names, axis: str = "data") -> tuple:
    """The JAX package's `_leaf_spec` of a state leaf named by its path:
    () replicated, (axis,) split on axis 0, (None, axis) on axis 1."""
    top = names[0] if names else ""
    if top in SHARDED:
        return (axis,)
    if top == "replay":
        return (None, axis) if len(names) > 1 and \
            names[1] in SLOT_AXIS_1 else (axis,)
    return ()


def leaves(x, path=()):
    """(path, tensor) of every tensor of a state: dataclass fields,
    NamedTuple fields, modules' named parameters, list items."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if isinstance(x, torch.nn.Module):
        return [(path + (k,), v) for k, v in x.named_parameters()]
    if dataclasses.is_dataclass(x):
        return [lf for f in dataclasses.fields(x)
                for lf in leaves(getattr(x, f.name), path + (f.name,))]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [lf for f in x._fields
                for lf in leaves(getattr(x, f), path + (f,))]
    if isinstance(x, (list, tuple)):
        return [lf for i, v in enumerate(x) for lf in leaves(v, path + (i,))]
    raise TypeError(f"state leaf of type {type(x)} at {path}")


def state_specs(ts, axis: str = "data") -> dict:
    """{dotted path: spec} of every tensor of the state `ts`."""
    return {".".join(str(n) for n in path): leaf_spec(path, axis)
            for path, _ in leaves(ts)}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generators in a run seeded `seed`."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


class DPAgentDDiffPG:
    """Data-parallel DDiffPG on one rank of `mesh` (`parallel/mesh.py`):
    the same algorithm, its env batch and replay split across the ranks."""

    def __init__(self, cfg, mesh, env_kwargs=None, device=None):
        from ddiffpg_tpu_torch.envs import make

        self.mesh = mesh
        self.axis = mesh.mesh_dim_names[0]
        self.group = mesh.get_group(self.axis)
        self.nd = nd = mesh.size()
        self.rank = dist.get_rank(self.group)
        a = cfg.algo
        for what, n in (("num_envs", cfg.num_envs),
                         ("algo.memory_size", int(a.memory_size)),
                         ("algo.batch_size", a.batch_size)):
            if n % nd:
                raise ValueError(f"{what}={n} does not divide across {nd} "
                                 "ranks")
        local = cfg.override(**{
            "num_envs": cfg.num_envs // nd,
            "algo.memory_size": int(a.memory_size) // nd,
            "algo.batch_size": a.batch_size // nd,
        })
        self.device = torch.device(device or mesh.device_type)
        seed = rank_seed(cfg.seed, self.rank)
        env = make(cfg.env.name, num_envs=local.num_envs, device=self.device,
                   seed=seed, **(env_kwargs or {}))
        self.agent = AgentDDiffPG(
            env, local, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(seed))
        # the recluster sees the global replay
        self.agent.cluster_manager.capacity = int(a.memory_size)
        self.cfg = cfg
        self.last_recluster = None       # rank 0's result, on every rank

    # ------------------------------------------------------------------ init

    def init(self, seed: int | None = None) -> DDiffPGState:
        """This rank's state: the weights drawn from `seed` (default
        cfg.seed) alike on every rank, its own envs' reset."""
        return self.agent.init(seed)

    # ----------------------------------------------------------- train step

    def _mean_logs(self, logs: dict) -> dict:
        keys = sorted(logs)
        vals = base.maybe_pmean(torch.stack(
            [logs[k].to(self.device, torch.float32) for k in keys]))
        return dict(zip(keys, vals.unbind(0)))

    def train_iter(self, ts: DDiffPGState, steps: int | None = None):
        """One train iteration on every rank; the logs are the ranks'
        means."""
        with base.data_parallel(self.group):
            ts, logs = self.agent.train_iter(ts, steps)
            return ts, self._mean_logs(logs)

    def warmup(self, ts: DDiffPGState) -> DDiffPGState:
        with base.data_parallel(self.group):
            return self.agent.warmup(ts)

    # --------------------------------------------------- recluster / eval

    @torch.no_grad()
    def update_cluster(self, ts: DDiffPGState) -> DDiffPGState:
        """Recluster the global replay on rank 0 and apply its result on
        every rank to that rank's slots."""
        ag = self.agent
        fields = ag.recluster_fields(ts)
        gathered = []
        for x in fields:
            if x is None:
                gathered.append(None)
                continue
            y = x.to(torch.uint8) if x.dtype == torch.bool else x
            parts = [torch.empty_like(y) for _ in range(self.nd)]
            dist.all_gather(parts, y.contiguous(), group=self.group)
            gathered.append(torch.cat(parts).to(x.dtype).cpu().numpy())
        payload = [None]
        if self.rank == 0:
            *tracks, protect = gathered
            res = ag.cluster_manager.recluster(
                *tracks, protect_slots=(None if protect is None
                                        else protect.nonzero()[0]))
            fresh = torch.randn(ts.embeddings.shape, generator=ag.generator,
                                device=ag.device).cpu()
            payload = [(res, fresh)]
        dist.broadcast_object_list(payload, src=dist.get_global_rank(
            self.group, 0), group=self.group, device=self._object_device())
        res, fresh = payload[0]
        self.last_recluster = res
        S = ts.replay.length.shape[0]
        return ag.apply_recluster(ts, res, fresh.to(ag.device),
                                  first_slot=self.rank * S)

    def _object_device(self):
        """Where broadcast_object_list stages its bytes: the card for NCCL,
        the CPU otherwise."""
        backend = dist.get_backend(self.group)
        return self.device if backend == "nccl" else torch.device("cpu")

    @property
    def num_groups(self) -> int:
        return self.agent.num_groups

    @property
    def num_clusters(self) -> int:
        return self.agent.num_clusters

    def eval_actor(self, ts, obs, **kw):
        return self.agent.eval_actor(ts, obs, **kw)

    def eval_policy(self, ts):
        """obs -> the eval policy's actions (the replicated actor)."""
        return lambda obs: self.agent.eval_actor(ts, obs)
