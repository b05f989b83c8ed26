"""ddiffpg_tpu_torch — the PyTorch + CUDA port of ddiffpg_tpu.

The JAX package `ddiffpg_tpu` stays the reference; this package holds the
ported modules under the same names, imports `torch`, never `jax`, and
nothing of `ddiffpg_tpu` (it keeps its own copies of the framework-free
modules it needs). Ported so far: DDiffPG's collect path (diffusion actor
acting, mode-embedding mixing, exploration noise, batched physics with
auto-reset) on antmaze-v1 and the Panda tasks with joint control, and its
training iteration (episodic replay, per-group C51 critics, the action
gradient, actor distillation, NovelD). On an NVIDIA card the physics
substep runs as the hand-written CUDA kernel `csrc/substep.cu`; on the CPU
it runs its plain PyTorch version.

  config.py    — the configuration dataclasses, presets, preprocess (copy)
  physics/     — scene builders, kinematics, the substep (plain + CUDA kernel)
  envs/        — antmaze-v1 and Panda batched envs, registry
  ops/         — DDPM, mode embeddings, noise, optax chains, C51 projection,
                 running stats, positional encoding
  models/      — the DDPM diffusion policy, stacked critics, RND nets
  replay/      — the episodic trajectory store
  intrinsic.py — NovelD / RND rewards
  agents/      — DDiffPG (explore_actions, collect, AgentDDiffPG), make_agent
  utils/       — maze coverage; JAX-package parameter and state conversion
"""

__version__ = "0.1.0"
