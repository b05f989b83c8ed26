"""Data parallelism over torch.distributed, one process per rank.

Counterpart of `ddiffpg_tpu/parallel/`: the JAX package shards the env
batch, the episodic replay and the exploration statistics along a `data`
mesh axis with `shard_map`, replicates the parameters and pmeans the
gradients before every optimizer step. Here each rank is a process that
holds its own share of the envs and the replay and the same parameters,
and the mean is an all_reduce over the process group (NCCL on the card,
gloo on the CPU, or gloo for several ranks on one card). Importing this
package starts no process group: the caller starts one
(`torch.distributed.init_process_group`, or `torchrun`) and builds the
mesh on it.
"""

from ddiffpg_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
