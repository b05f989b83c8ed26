"""Maze grid specs and scene compilation (numpy only).

Copy of `ddiffpg_tpu/physics/maze.py`: the tables `MAZES`, `GOALS` and
`EPISODE_LEN`, the scene compilers `compile_boxes` and `compile_sdf`, and
the grid navigation helpers `free_cells`, `xy_to_rowcol`, `bfs_next_cell`
and `waypoint_policy` (plain Python on the host). Grid layouts match the
reference's single/multi-goal mazes; wall cells compile to static AABBs,
offset so the robot reset cell ('r') is the world origin.
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


def free_cells(maze_map):
    """(row, col) of every non-wall cell."""
    return [(i, j) for i, row in enumerate(maze_map)
            for j, c in enumerate(row) if c != 1]


def xy_to_rowcol(xy, maze_map, size_scaling: float = 4.0):
    """World xy -> grid cell, with the reset-cell origin offset
    (reference maze_env.py:324-328 semantics)."""
    ri, rj = find_reset(maze_map)
    col = int(round((xy[0] + rj * size_scaling) / size_scaling))
    row = int(round((xy[1] + ri * size_scaling) / size_scaling))
    return row, col


def bfs_next_cell(maze_map, current, target):
    """Shortest-path BFS waypoint: the next cell to move to from `current`
    toward `target` (reference maze_env.py:433-467 `_get_best_next_rowcol`).
    Returns `target` when adjacent or equal."""
    current, target = tuple(current), tuple(target)
    if current == target:
        return target
    visited = set()
    frontier = [target]
    while frontier:
        nxt = []
        for cell in frontier:
            visited.add(cell)
            r, c = cell
            for nb in ((r, c - 1), (r, c + 1), (r + 1, c), (r - 1, c)):
                if nb == current:
                    return cell
                rr, cc = nb
                if not (0 <= rr < len(maze_map)
                        and 0 <= cc < len(maze_map[0])):
                    continue
                if maze_map[rr][cc] == 1 or nb in visited:
                    continue
                nxt.append(nb)
        frontier = nxt
    raise ValueError("no path found to target")


def waypoint_policy(maze_map, goal_xy, size_scaling: float = 4.0):
    """Host-side navigation helper: maps an xy position to the next
    waypoint xy along the BFS shortest path to `goal_xy` (the engine-free
    analog of maze_env.create_navigation_policy, maze_env.py:469-504)."""
    ri, rj = find_reset(maze_map)

    def rowcol_to_xy(rc):
        r, c = rc
        return (c * size_scaling - rj * size_scaling,
                r * size_scaling - ri * size_scaling)

    def next_waypoint(xy):
        cur = xy_to_rowcol(xy, maze_map, size_scaling)
        tgt = xy_to_rowcol(goal_xy, maze_map, size_scaling)
        wp = bfs_next_cell(maze_map, cur, tgt)
        if wp == tgt:
            return tuple(goal_xy)
        return rowcol_to_xy(wp)

    return next_waypoint


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
