"""ddiffpg_tpu_torch — the PyTorch + CUDA port of ddiffpg_tpu.

The JAX package `ddiffpg_tpu` stays the reference; this package holds the
ported modules under the same names, imports `torch`, never `jax`, and
nothing of `ddiffpg_tpu` (it keeps its own copies of the framework-free
modules it needs). Ported so far: DDiffPG's whole training loop on every
env of the JAX package: the collect path (diffusion actor acting,
mode-embedding mixing, exploration noise, batched physics with
auto-reset), the training iteration (episodic replay, per-group C51
critics, the action gradient, actor distillation, NovelD), the DTW
recluster with the Q-scheduler, eval rollouts, checkpoints and the
`train` entry point; and the baselines TD3, SAC, DIPO and DiffQ (the flat
n-step replay, obs normalisation) through the same entry point. On an
NVIDIA card the physics substep runs as the hand-written CUDA kernel
`csrc/substep.cu` and the recluster's DTW distances as `csrc/dtw.cu`; on
the CPU both run their plain PyTorch versions.

  config.py    — the configuration dataclasses, presets, preprocess, the
                 YAML loader (copy)
  physics/     — scene builders, kinematics, the substep (plain + CUDA kernel)
  envs/        — the antmaze, pointmaze and Panda batched envs, registry
  ops/         — DDPM, mode embeddings, noise, optax chains, C51 projection,
                 running stats, positional encoding, DTW (plain + CUDA
                 kernel), the n-step window, schedules
  models/      — the DDPM diffusion policy, the baseline diffusion actor,
                 MLP policies, stacked and double critics, RND nets
  replay/      — the episodic trajectory store, the flat transition ring
  modes/       — DTW + average-linkage reclustering (`csrc/cluster.cpp` for
                 the linkage and a host float64 DTW), the Q-scheduler
  intrinsic.py — NovelD / RND rewards
  agents/      — DDiffPG (explore_actions, collect, AgentDDiffPG with
                 update_cluster), TD3, SAC, DIPO, DiffQ, eval rollouts,
                 make_agent
  utils/       — maze coverage, logger, checkpoints, JAX-package parameter
                 and state conversion
  tools/       — timing and A/B tools, modes of a run, archive reruns
  train.py     — the entry point: `python -m ddiffpg_tpu_torch.train`
"""

from pathlib import Path

__version__ = "0.1.0"

LIB_PATH = Path(__file__).resolve().parent
