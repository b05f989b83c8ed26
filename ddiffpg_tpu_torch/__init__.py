"""ddiffpg_tpu_torch — the PyTorch + CUDA port of ddiffpg_tpu.

The JAX package `ddiffpg_tpu` stays the reference; this package holds the
ported modules under the same names, imports `torch`, never `jax`, and
nothing of `ddiffpg_tpu` (it keeps its own copies of the framework-free
modules it needs). Ported so far: DDiffPG's collect path (diffusion actor
acting, mode-embedding mixing, mixed exploration noise, batched physics
with auto-reset) on antmaze-v1 and the Panda tasks with joint control. On
an NVIDIA card the physics substep runs as the hand-written CUDA kernel
`csrc/substep.cu`; on the CPU it runs its plain PyTorch version.

  config.py  — the configuration dataclasses (copy)
  physics/   — scene builders, kinematics, the substep (plain + CUDA kernel)
  envs/      — antmaze-v1 and Panda batched envs, registry
  ops/       — DDPM tables and steps, mode embeddings, exploration noise
  models/    — the DDPM diffusion policy
  agents/    — DDiffPG acting (explore_actions, collect)
  utils/     — JAX-package parameter conversion (numpy in, tensors out)
"""

__version__ = "0.1.0"
