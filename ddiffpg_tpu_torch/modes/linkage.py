"""Average-linkage agglomerative clustering (host side, eval cadence).

Copy of `ddiffpg_tpu/modes/linkage.py`: `linkage_average` (scipy's
linkage(method="average") through the nearest-neighbor-chain algorithm
with the Lance-Williams update) and `fcluster_distance` (flat clusters cut
at a height, the 'distance' criterion). `linkage_average` runs the native
library (`csrc/cluster.cpp`, `modes/_native.py`) and raises if it cannot be
built; `_linkage_average_numpy` is its plain version, which the tests hold
it to.
"""

from __future__ import annotations

import numpy as np


def linkage_average(dist: np.ndarray) -> np.ndarray:
    """dist: [N, N] symmetric. Returns scipy-compatible Z [N-1, 4]
    (cluster1, cluster2, height, size), merges sorted by height and
    relabeled exactly like scipy's nn-chain output."""
    from ddiffpg_tpu_torch.modes import _native

    return _native.linkage_average(dist)


def _linkage_average_numpy(dist: np.ndarray) -> np.ndarray:
    N = dist.shape[0]
    if N < 2:
        return np.zeros((0, 4))
    D = dist.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    size = np.ones(N)
    active = np.ones(N, bool)
    # cluster label of each row (rows get reused for merged clusters)
    label = np.arange(N)
    merges = []
    chain: list[int] = []
    n_merges = 0
    while n_merges < N - 1:
        if not chain:
            chain.append(int(np.argmax(active)))
        a = chain[-1]
        row = np.where(active, D[a], np.inf)
        row[a] = np.inf
        b = int(np.argmin(row))
        if len(chain) > 1 and b == chain[-2]:
            # reciprocal nearest neighbors -> merge a and b
            h = D[a, b]
            merges.append((label[a], label[b], h, size[a] + size[b]))
            # Lance-Williams average-linkage update into row a
            na, nb = size[a], size[b]
            newrow = (na * D[a] + nb * D[b]) / (na + nb)
            D[a], D[:, a] = newrow, newrow
            D[a, a] = np.inf
            active[b] = False
            size[a] = na + nb
            label[a] = N + n_merges
            n_merges += 1
            chain.pop()
            chain.pop()
        else:
            chain.append(b)

    Z = np.array(merges, dtype=np.float64)
    # sort by height and relabel like scipy
    order = np.argsort(Z[:, 2], kind="stable")
    Z = Z[order]
    relabel = {}
    for i in range(N):
        relabel[i] = i
    old_new = {}
    for new_i, old_i in enumerate(order):
        old_new[N + old_i] = N + new_i
    out = np.zeros_like(Z)
    for i, (c1, c2, h, s) in enumerate(Z):
        c1 = old_new.get(int(c1), int(c1))
        c2 = old_new.get(int(c2), int(c2))
        out[i] = (min(c1, c2), max(c1, c2), h, s)
    return out


def fcluster_distance(Z: np.ndarray, n: int, threshold: float) -> np.ndarray:
    """Flat clusters: union all merges with height <= threshold.
    Returns labels [n] in 1..k (scipy fcluster convention)."""
    parent = list(range(n + max(len(Z), 0) + 1))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, (c1, c2, h, _s) in enumerate(Z):
        new = n + i
        if h <= threshold:
            for c in (int(c1), int(c2)):
                parent[find(c)] = new
        else:
            # keep tree structure for label propagation of later merges
            pass
    roots = {}
    labels = np.zeros(n, np.int64)
    nxt = 1
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = nxt
            nxt += 1
        labels[i] = roots[r]
    return labels
