"""Diagnostic plots: eval trajectories, per-mode clusters, the dendrogram
and the exploration heatmap, as RGB arrays for the logger.

Copy of `ddiffpg_tpu/utils/plotting.py`, with the maze boxes from the
port's own `physics/maze.py:compile_boxes`. The inputs are numpy arrays
(the train loop hands over host copies). matplotlib is imported inside
each function, with the `Agg` backend selected there, so importing this
module needs no matplotlib.
"""

from __future__ import annotations

import numpy as np


def _fig_to_array(fig):
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = buf.reshape(h, w, 4)[:, :, :3].copy()
    import matplotlib.pyplot as plt

    plt.close(fig)
    return img


def _draw_maze(ax, maze_map, size_scaling=4.0):
    from matplotlib.patches import Rectangle

    from ddiffpg_tpu_torch.physics.maze import compile_boxes

    for (mn, mx) in compile_boxes(maze_map, size_scaling):
        ax.add_patch(Rectangle((mn[0], mn[1]), mx[0] - mn[0], mx[1] - mn[1],
                               color="0.6"))
    ax.set_aspect("equal")


def plot_traj(maze_map, xy, size_scaling=4.0):
    """Eval xy scatter over the maze."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    _draw_maze(ax, maze_map, size_scaling)
    xy = np.asarray(xy).reshape(-1, 2)
    ax.scatter(xy[:, 0], xy[:, 1], s=1, c="tab:blue", alpha=0.5)
    return _fig_to_array(fig)


def plot_cluster(maze_map, traj_list, clusters, size_scaling=4.0):
    """Trajectories coloured by their cluster: `clusters` holds, per
    cluster, indices into `traj_list`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    _draw_maze(ax, maze_map, size_scaling)
    cmap = plt.get_cmap("tab10")
    for ci, idxs in enumerate(clusters):
        for k in idxs:
            tr = np.asarray(traj_list[k])
            ax.plot(tr[:, 0], tr[:, 1], color=cmap(ci % 10), lw=0.7, alpha=0.7)
    return _fig_to_array(fig)


def plot_hierarchy(Z):
    """Dendrogram of a linkage matrix."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import dendrogram

    fig, ax = plt.subplots(figsize=(6, 4))
    dendrogram(np.asarray(Z), ax=ax, no_labels=True)
    return _fig_to_array(fig)


def plot_heatmap(grid, vmax=100):
    """Exploration-density heatmap of a [res, res] visit grid (walls -1)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = np.array(grid, dtype=np.float64)
    g[g == -1] = 0
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(np.clip(g, 0, vmax), cmap="Reds")
    ax.set_xticks([])
    ax.set_yticks([])
    return _fig_to_array(fig)
