"""Maze grid specs and scene compilation (numpy only).

Copy of the tables and compilers of `ddiffpg_tpu/physics/maze.py` that the
port uses: `MAZES`, `GOALS`, `EPISODE_LEN`, `compile_boxes` and
`compile_sdf`. Grid layouts match the reference's single/multi-goal mazes;
wall cells compile to static AABBs, offset so the robot reset cell ('r') is
the world origin.
"""

from __future__ import annotations

import numpy as np

R, G = "r", "g"

MAZE_v1 = [[1, 1, 1, 1, 1],
           [1, 0, 0, 0, 1],
           [1, G, 1, R, 1],
           [1, 0, 0, 0, 1],
           [1, 1, 1, 1, 1]]

MAZE_v2 = [[1, 1, 1, 1, 1, 1, 1],
           [1, 0, 1, 1, 1, 0, 1],
           [1, 0, 1, 1, 1, 0, 1],
           [1, 0, 0, R, 0, G, 1],
           [1, 0, 1, 1, 1, 0, 1],
           [1, G, 1, 1, 1, 0, 1],
           [1, 1, 1, 1, 1, 1, 1]]

MAZE_v2_hard = [[1, 1, 1, 1, 1, 1, 1, 1, 1],
                [1, 0, 0, 0, G, 0, 0, 0, 1],
                [1, 0, 0, 0, 1, 0, 0, 0, 1],
                [1, 0, 0, 0, 0, 0, 0, 0, 1],
                [1, G, 1, 0, R, 0, 1, G, 1],
                [1, 0, 0, 0, 0, 0, 0, 0, 1],
                [1, 0, 0, 0, 1, 0, 0, 0, 1],
                [1, 0, 0, 0, G, 0, 0, 0, 1],
                [1, 1, 1, 1, 1, 1, 1, 1, 1]]

MAZE_v3 = [[1, 1, 1, 1, 1, 1, 1, 1, 1],
           [1, 0, 0, 0, 0, 0, 1, G, 1],
           [1, 0, 1, 1, 0, 0, 0, 0, 1],
           [1, 0, 0, 0, 0, 0, 1, 0, 1],
           [1, 0, 1, 0, R, 0, 0, 0, 1],
           [1, 0, 0, 0, 0, 0, 1, 0, 1],
           [1, 0, 1, 1, 0, 0, 1, 0, 1],
           [1, G, 0, 0, 0, 0, 0, 0, 1],
           [1, 1, 1, 1, 1, 1, 1, 1, 1]]

MAZE_v4 = [[1, 1, 1, 1, 1, 1, 1],
           [1, 0, 0, 0, 1, 0, 1],
           [1, G, 1, 0, 0, 0, 1],
           [1, 0, 0, 0, 1, R, 1],
           [1, G, 1, 0, 0, 0, 1],
           [1, 0, 0, 0, 1, 0, 1],
           [1, 1, 1, 1, 1, 1, 1]]

MAZE_v5 = [[1, 1, 1, 1, 1, 1, 1],
           [1, 0, 1, 0, 0, 0, 1],
           [1, 0, 0, 0, 1, 0, 1],
           [1, G, 1, 0, 0, R, 1],
           [1, 0, 0, 0, 1, 0, 1],
           [1, 0, 1, 0, 0, 0, 1],
           [1, 1, 1, 1, 1, 1, 1]]

MAZES = {"antmaze-v1": MAZE_v1, "antmaze-v2": MAZE_v2, "antmaze-v3": MAZE_v3,
         "antmaze-v4": MAZE_v4, "antmaze-v5": MAZE_v5,
         "antmaze-v2-hard": MAZE_v2_hard}

# fixed goal xy lists per maze (reference maze_env.py:372-385); the second
# element of each tuple is the sparse reward granted at that goal
GOALS = {
    "antmaze-v1": [((-8.0, 0.0), 10.0)],
    "antmaze-v2": [((-8.0, 8.0), 20.0), ((8.0, 0.0), 10.0)],
    "antmaze-v2-hard": [((-12.0, 0.0), 10.0), ((12.0, 0.0), 10.0),
                        ((0.0, 12.0), 10.0), ((0.0, -12.0), 10.0)],
    "antmaze-v3": [((-12.0, 12.0), 10.0), ((12.0, -12.0), 10.0)],
    "antmaze-v4": [((-16.0, 4.0), 10.0), ((-16.0, -4.0), 10.0)],
    "antmaze-v5": [((-16.0, 0.0), 10.0)],
}

EPISODE_LEN = {"antmaze-v1": 500, "antmaze-v2": 500,
               "antmaze-v3": 700, "antmaze-v4": 700}


def find_reset(maze_map):
    for i, row in enumerate(maze_map):
        for j, c in enumerate(row):
            if c == R:
                return i, j
    raise ValueError("no reset cell")


def compile_boxes(maze_map, size_scaling: float = 4.0, height: float = 0.5):
    """Wall cells -> AABBs [(min, max)], offset so 'r' is the origin."""
    ri, rj = find_reset(maze_map)
    tx, ty = rj * size_scaling, ri * size_scaling
    boxes = []
    half = 0.5 * size_scaling
    hz = height * size_scaling  # box full height = maze_height * scaling
    for i, row in enumerate(maze_map):
        for j, c in enumerate(row):
            if c == 1:
                cx = j * size_scaling - tx
                cy = i * size_scaling - ty
                boxes.append(((cx - half, cy - half, 0.0),
                              (cx + half, cy + half, hz)))
    return np.asarray(boxes, np.float32)


def compile_sdf(maze_map, size_scaling: float = 4.0, cell: float = 0.125,
                margin: float = 2.0):
    """Precompute a 2-D signed-distance field of the wall boxes (distance
    to the union surface; negative inside a wall) plus its gradient grid.
    One bilinear lookup per contact probe replaces testing against every
    wall box — the box tests were the dominant HBM traffic of the substep
    ([probes, boxes, B, 3] tensors)."""
    boxes = compile_boxes(maze_map, size_scaling)
    lo = boxes[:, 0, :2].min(axis=0) - margin
    hi = boxes[:, 1, :2].max(axis=0) + margin
    nx = int(np.ceil((hi[0] - lo[0]) / cell)) + 1
    ny = int(np.ceil((hi[1] - lo[1]) / cell)) + 1
    xs = lo[0] + np.arange(nx) * cell
    ys = lo[1] + np.arange(ny) * cell
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    P = np.stack([X, Y], axis=-1)                       # [nx, ny, 2]

    dist = np.full((nx, ny), np.inf, np.float32)
    for (mn, mx) in boxes:
        d = np.maximum(mn[None, None, :2] - P, P - mx[None, None, :2])
        outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
        inside = np.minimum(np.max(d, axis=-1), 0.0)
        dist = np.minimum(dist, (outside + inside).astype(np.float32))

    gx, gy = np.gradient(dist, cell)
    grad = np.stack([gx, gy], axis=-1).astype(np.float32)
    n = np.linalg.norm(grad, axis=-1, keepdims=True)
    grad = grad / np.maximum(n, 1e-6)
    zmax = float(boxes[:, 1, 2].max())
    return dict(sdf_dist=dist, sdf_grad=grad,
                sdf_origin=(float(lo[0]), float(lo[1])), sdf_cell=cell,
                sdf_zmax=zmax)
