"""Per-mode critic lifecycle (host-side planning, device-side application).

Copy of `ddiffpg_tpu/modes/q_scheduler.py`. Mirrors the reference `Q_scheduler`
(`ddiffpg/utils/Q_scheduler.py:31-103` upstream): on every recluster,
new clusters are matched to old ones by maximum trajectory-id overlap;

  * no overlap        -> critic cloned from the explore critic (row 0),
                          fresh optimizer, fresh random embedding
  * first claim       -> critic row + optimizer + embedding inherited
  * duplicate claim   -> critic cloned from the parent, fresh optimizer;
                          the claimant with the LARGER overlap keeps the
                          parent's embedding, the other gets a fresh one

Instead of Python lists of torch modules + deepcopy, critics live as one
stacked parameter pytree with a leading [G_max] group axis; the plan below
is applied as a single gather (`src_row`) + masked optimizer reset.
`parent_row` carries the reference's `indices` semantics for the
target-action remap (0 = explore row, -1 = raw actions).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class SchedulerPlan:
    num_groups: int                 # 1 + num_clusters
    src_row: np.ndarray             # [G_max] old stacked row to copy params from
    fresh_opt: np.ndarray           # [G_max] bool: reset optimizer state
    parent_row: np.ndarray          # [G_max] target-action remap (0/-1/old row)
    embedding_src: np.ndarray       # [G_max] old embedding row to inherit, -1 = fresh


@dataclass
class QScheduler:
    max_groups: int
    last_cluster: List[List[int]] = field(default_factory=list)

    def update_cluster(self, clusters: List[List[int]]) -> SchedulerPlan:
        G = self.max_groups
        src_row = np.zeros(G, np.int64)          # default: copy explore row
        fresh_opt = np.zeros(G, bool)
        parent_row = np.zeros(G, np.int64)
        emb_src = np.full(G, -1, np.int64)
        emb_src[0] = 0                           # explore embedding persists

        if len(clusters) == 0:
            pass
        elif len(self.last_cluster) == 0:
            # first clustering: every mode critic starts as a clone of the
            # explore critic with a fresh optimizer + fresh embedding
            for i in range(len(clusters)):
                src_row[i + 1] = 0
                fresh_opt[i + 1] = True
                parent_row[i + 1] = 0
                emb_src[i + 1] = -1
        else:
            claimed: List[int] = []
            overlaps: List[int] = []
            emb_claim = {}                       # old row -> (new row, overlap)
            for i, cl in enumerate(clusters):
                best, idx = 0, None
                for j, old in enumerate(self.last_cluster):
                    ov = len(set(cl) & set(old))
                    if ov > best:
                        best, idx = ov, j
                row = i + 1
                if idx is None:
                    src_row[row] = 0
                    fresh_opt[row] = True
                    parent_row[row] = 0
                    emb_src[row] = -1
                    claimed.append(0)
                elif (idx + 1) in claimed:
                    src_row[row] = idx + 1
                    fresh_opt[row] = True
                    parent_row[row] = idx + 1
                    # embedding: larger overlap keeps the parent's embedding
                    prev_row, prev_ov = emb_claim[idx + 1]
                    if best > prev_ov:
                        emb_src[row] = idx + 1
                        emb_src[prev_row] = -1
                        emb_claim[idx + 1] = (row, best)
                    else:
                        emb_src[row] = -1
                    claimed.append(idx + 1)
                else:
                    src_row[row] = idx + 1
                    fresh_opt[row] = False       # same critic, same optimizer
                    parent_row[row] = idx + 1
                    emb_src[row] = idx + 1
                    emb_claim[idx + 1] = (row, best)
                    claimed.append(idx + 1)
                overlaps.append(best)

        self.last_cluster = [list(c) for c in clusters]
        return SchedulerPlan(
            num_groups=1 + len(clusters), src_row=src_row,
            fresh_opt=fresh_opt, parent_row=parent_row, embedding_src=emb_src)
