"""The replay's groups after a train cell's recluster, worked out again
from the replay's raw trajectories, and the program's groups judged
against them.

The train cell's replay holds successes on the maze's corridors and
failures. The recluster puts each corridor's successes in one mode row,
each failure in the one mode row whose sampled members lie nearest by DTW,
and empties slots where a mode holds more than `memory_size // (2 * modes)`
successes or failures (a random draw). This reference works out from the
raw trajectories what needs no DTW and no draw: row 0 is every stored
trajectory, each success goes to the mode row of its corridor (by the sign
of its track's mean y), no mode holds more than its cap. Two things it
takes from the program as given, and judges only by those rules: which
mode row each failure went to, and which slots the eviction emptied (they
read as empty: length 0, traj_id -1). The mode rows carry the program's
order, a label the comparison does not depend on.

Every fresh trajectory starts with its target action equal to its raw
action in every group row, and the recluster from one group keeps that, so
the target actions before the first update pass are the raw actions.
"""

from __future__ import annotations

import torch


def corridor(replay: dict) -> torch.Tensor:
    """[S] +1 or -1: the sign of the mean y along each stored track; 0 for
    an empty slot."""
    L = replay["obs"].shape[1] - 1
    steps = torch.arange(L + 1)
    live = (steps[None] <= replay["length"][:, None]).float()
    mean_y = (replay["obs"][:, :, 1] * live).sum(1) / live.sum(1).clamp(
        min=1)
    valid = (replay["traj_id"] >= 0) & (replay["length"] > 0)
    return torch.where(valid, torch.sign(mean_y), torch.zeros_like(mean_y))


def derive(replay: dict, program_mask: torch.Tensor, num_groups: int,
           capacity: int) -> tuple[torch.Tensor, int]:
    """(the reference's group mask [G_max, S], the program's faults): the
    count of (row, slot) where the program's mask differs from it, of
    stored failures the program put in no mode row or in more than one,
    of a mode's members beyond its cap, and 1 if the corridors' successes
    do not lie in distinct mode rows, one for each mode."""
    pm = program_mask.bool().cpu()
    G = num_groups
    valid = (replay["traj_id"] >= 0) & (replay["length"] > 0)
    succ = valid & (replay["success"] > 0)
    fail = valid & (replay["success"] == 0)
    side = corridor(replay)
    mask = torch.zeros(pm.shape, dtype=torch.bool)
    mask[0] = valid
    faults = 0

    # a corridor's mode row: the one holding most of its successes
    sides = [v for v in (1.0, -1.0) if bool((succ & (side == v)).any())]
    rows = {}
    for v in sides:
        members = succ & (side == v)
        rows[v] = 1 + int(pm[1:G, members].sum(1).argmax())
        mask[rows[v], members] = True
    if len(set(rows.values())) != len(sides) or len(sides) != G - 1:
        faults += 1

    in_modes = pm[1:G].sum(0)
    faults += int((fail & (in_modes != 1)).sum())
    one = fail & (in_modes == 1)
    mask[1 + pm[1:G].long().argmax(0)[one], one.nonzero().flatten()] = True

    cap = capacity // (2 * (G - 1))
    for g in range(1, G):
        for kind in (succ, fail):
            faults += max(0, int((mask[g] & kind).sum()) - cap)
    faults += int((pm != mask).sum())
    return mask, faults


def target_actions(action: torch.Tensor, rows: int) -> torch.Tensor:
    """[G_max, S, L, A] from the raw actions [S, L, A]: every row alike."""
    return action[None].expand((rows,) + tuple(action.shape)).clone()
