"""The plain PyTorch reference of the benchmark.

Frozen copies of the plain code of `ddiffpg_tpu_torch` as the benchmark
was first written (the scene builders, the plain substep, the envs, the
diffusion actor, the stacked C51 critics, NovelD, the episodic replay, the
optax chains and DDiffPG's collect and update pass), with their imports
rewritten to this package. The reference steps the plain substep on every
device (no kernel), builds no recluster, and imports nothing of the
program, of JAX or of the JAX package. `follow.py` drives it beside a run.
A later change to the program does not move it.
"""
