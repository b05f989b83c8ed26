"""Maze-visitation density and coverage (antmaze's `train/state_coverage`).

Counterpart of `ddiffpg_tpu/utils/density.py` (the reference's
DensityTracker, utils/common.py:239-304): a [res, res] int32 grid over the
maze with -1 on walls; every explore step adds the env batch's xy
positions; coverage is the fraction of free cells ever visited.
"""

from __future__ import annotations

import numpy as np
import torch


def create_grid(maze_map, resolution: int):
    """(grid [res, res] int32 with -1 walls, reset cell (row, col), number
    of free cells)."""
    n = len(maze_map)
    if resolution % n:
        raise ValueError(f"resolution {resolution} is not a multiple of {n}")
    scale = resolution // n
    grid = np.zeros((resolution, resolution), np.int32)
    reset = None
    for i in range(n):
        for j in range(len(maze_map[i])):
            c = maze_map[i][j]
            if c == 1:
                grid[i * scale:(i + 1) * scale, j * scale:(j + 1) * scale] = -1
            elif c == "r":
                reset = (i * scale + scale // 2, j * scale + scale // 2)
    return grid, np.asarray(reset, np.int64), int((grid == 0).sum())


def update(grid: torch.Tensor, xy: torch.Tensor, maze_size_scaling: float,
           reset, maze_rows: int) -> torch.Tensor:
    """Add one visit per env at its xy [E, 2] (world coordinates). Wall
    cells are masked out, so a probe inside a wall cannot turn a -1 cell
    into a visited one."""
    res = grid.shape[0]
    idx = xy / maze_size_scaling * (res // maze_rows)
    ix = (-idx[:, 1] + int(reset[0])).to(torch.int32).clamp(0, res - 1).long()
    iy = (idx[:, 0] + int(reset[1])).to(torch.int32).clamp(0, res - 1).long()
    free = (grid[ix, iy] >= 0).to(grid.dtype)
    return grid.index_put((ix, iy), free, accumulate=True)


def coverage(grid: torch.Tensor, num_free: int) -> torch.Tensor:
    return (grid > 0).sum() / num_free
