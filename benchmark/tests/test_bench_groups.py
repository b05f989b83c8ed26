"""The train cell's replay groups, worked out again from the raw
trajectories (`benchmark/reference/groups.py`): a recluster that follows
the rules reads no fault, each broken rule reads one at least."""

import pytest
import torch

from benchmark.reference import groups

G_MAX, L = 5, 6


def _replay():
    """12 slots: 3 successes on each corridor (y = +4 and -4), 4
    failures, 2 empty."""
    S = 12
    obs = torch.zeros((S, L + 1, 3))
    obs[0:3, :, 1] = 4.0
    obs[3:6, :, 1] = -4.0
    obs[6:10, :, 1] = torch.randn(4, L + 1) * 0.1
    length = torch.tensor([L] * 10 + [0, 0], dtype=torch.int32)
    traj_id = torch.tensor(list(range(10)) + [-1, -1], dtype=torch.int32)
    success = torch.tensor([1] * 6 + [0] * 6, dtype=torch.int32)
    return {"obs": obs, "length": length, "traj_id": traj_id,
            "success": success,
            "action": torch.randn((S, L, 2))}


def _program_mask():
    """Corridor +4 in row 2, corridor -4 in row 1, failures 6, 7 to row 1
    and 8, 9 to row 2."""
    m = torch.zeros((G_MAX, 12), dtype=torch.bool)
    m[0, :10] = True
    m[2, 0:3] = True
    m[1, 3:6] = True
    m[1, 6:8] = True
    m[2, 8:10] = True
    return m


def test_a_recluster_by_the_rules_reads_no_fault():
    mask, faults = groups.derive(_replay(), _program_mask(), 3, 24)
    assert faults == 0
    assert torch.equal(mask, _program_mask())


def _success_to_the_other_mode(m):
    m[2, 0], m[1, 0] = False, True


def _failure_in_two_modes(m):
    m[2, 6] = True


def _failure_in_no_mode(m):
    m[1, 7] = False


def _empty_slot_in_a_mode(m):
    m[1, 10] = True


def _stored_slot_out_of_row_0(m):
    m[0, 4] = False


def _a_row_past_the_live_groups(m):
    m[3, 0] = True


def _both_corridors_in_one_mode(m):
    m[1, 0:3], m[2, 0:3] = True, False


@pytest.mark.parametrize("fault", [
    _success_to_the_other_mode, _failure_in_two_modes, _failure_in_no_mode,
    _empty_slot_in_a_mode, _stored_slot_out_of_row_0,
    _a_row_past_the_live_groups, _both_corridors_in_one_mode])
def test_each_broken_rule_reads_a_fault(fault):
    m = _program_mask()
    fault(m)
    _, faults = groups.derive(_replay(), m, 3, 24)
    assert faults >= 1


def test_a_mode_past_its_cap_reads_a_fault():
    # capacity 8 over 2 modes: at most 2 successes and 2 failures a mode
    _, faults = groups.derive(_replay(), _program_mask(), 3, 8)
    assert faults == 2


def test_target_actions_are_the_raw_actions_in_every_row():
    a = _replay()["action"]
    ta = groups.target_actions(a, G_MAX)
    assert ta.shape == (G_MAX,) + tuple(a.shape)
    assert all(torch.equal(ta[g], a) for g in range(G_MAX))
