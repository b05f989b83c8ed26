"""Rigid-body physics of the port.

  types.py, builder.py          — numpy scene builders (jax-free copies)
  ant.py, panda.py, maze.py     — the ant, the Panda scenes, the maze tables
                                  and grid navigation
  quat.py, engine.py            — quaternions and batched kinematics (FK,
                                  subspaces, body velocities)
  substep.py                    — model check, constants, plain substep
  substep_cuda.py               — build/load/launch of csrc/substep.cu
  engine_cl.py                  — the JAX package's batched XLA engine in
                                  plain PyTorch (SDF walls; use_pallas=False)
"""
