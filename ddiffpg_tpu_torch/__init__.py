"""ddiffpg_tpu_torch — the PyTorch + CUDA port of ddiffpg_tpu.

The JAX package `ddiffpg_tpu` stays the reference; this package holds the
ported modules under the same names, imports `torch`, never `jax`, and
nothing of `ddiffpg_tpu` (it keeps its own copies of the framework-free
modules it needs). Ported so far: DDiffPG's whole training loop on
antmaze-v1 (and the Panda tasks with joint control): the collect path
(diffusion actor acting, mode-embedding mixing, exploration noise,
batched physics with auto-reset), the training iteration (episodic
replay, per-group C51 critics, the action gradient, actor distillation,
NovelD), the DTW recluster with the Q-scheduler, eval rollouts,
checkpoints and the `train` entry point. On an NVIDIA card the physics
substep runs as the hand-written CUDA kernel `csrc/substep.cu` and the
recluster's DTW distances as `csrc/dtw.cu`; on the CPU both run their
plain PyTorch versions.

  config.py    — the configuration dataclasses, presets, preprocess (copy)
  physics/     — scene builders, kinematics, the substep (plain + CUDA kernel)
  envs/        — antmaze-v1 and Panda batched envs, registry
  ops/         — DDPM, mode embeddings, noise, optax chains, C51 projection,
                 running stats, positional encoding, DTW (plain + CUDA kernel)
  models/      — the DDPM diffusion policy, stacked critics, RND nets
  replay/      — the episodic trajectory store
  modes/       — DTW + average-linkage reclustering (`csrc/cluster.cpp` for
                 the linkage), the Q-scheduler
  intrinsic.py — NovelD / RND rewards
  agents/      — DDiffPG (explore_actions, collect, AgentDDiffPG with
                 update_cluster), eval rollouts, make_agent
  utils/       — maze coverage, logger, checkpoints, JAX-package parameter
                 and state conversion
  train.py     — the entry point: `python -m ddiffpg_tpu_torch.train`
"""

__version__ = "0.1.0"
