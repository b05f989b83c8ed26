"""The benchmark of `ddiffpg_tpu_torch` on an NVIDIA card.

`run.py` runs one cell of `BENCHMARK.json` once. Everything a cell needs is
found by name: its configuration under `configs/`, its traffic under
`traffic/`, the driver of its window under `drivers/` (by the traffic's
`kind`), each per-layer metric's reader under `metrics/`. `reference/`
holds the plain PyTorch reference that decides `correct`; `harness/` the
parts every cell shares (the run, the seeded weights, the profiler's
reduction, the frozen FLOP and substep counts, the comparison).
"""
