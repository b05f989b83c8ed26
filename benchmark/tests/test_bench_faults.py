"""A run with the timed path broken underneath comes out not correct:
the harness's whole run (set-up, window, the reference, the comparison)
on the CPU at tiny sizes, the program patched at the fault."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _not_correct(out, gap):
    res = out["result"]
    rows = {r["name"]: r for r in out["compared"]}
    assert not res["correct"]
    assert rows[gap]["value"] > rows[gap]["limit"], rows


def test_train_step_that_leaves_its_state_unchanged(monkeypatch):
    from ddiffpg_tpu_torch.ops import optim

    def no_step(params, grads, state, spec):
        return optim.global_norm(grads, state.count.dim())

    monkeypatch.setattr(optim, "adam_step", no_step)
    _not_correct(tiny.run("ddiffpg-antmaze-v1.train"), "change_gap")


def test_train_half_of_the_batch(monkeypatch):
    from ddiffpg_tpu_torch.replay import episodic as ep

    sample = ep.sample_group

    def half(*args, **kwargs):
        gb = sample(*args, **kwargs)
        b = gb.obs.shape[0]
        idx = torch.arange(b) % max(b // 2, 1)
        return ep.GroupBatch(*(x[idx] for x in gb))

    monkeypatch.setattr(ep, "sample_group", half)
    _not_correct(tiny.run("ddiffpg-antmaze-v1.train"), "loss_gap")


def test_collect_env_step_that_leaves_its_state_unchanged(monkeypatch):
    from ddiffpg_tpu_torch.envs import antmaze

    monkeypatch.setattr(antmaze, "step_physics",
                        lambda env, qpos, qvel, ctrl: (qpos, qvel))
    _not_correct(tiny.run("ddiffpg-antmaze-v1.collect"), "obs_gap")


def test_collect_half_of_the_envs(monkeypatch):
    from ddiffpg_tpu_torch.envs import antmaze

    step = antmaze.step_physics

    def half(env, qpos, qvel, ctrl):
        h = qpos.shape[0] // 2
        q, v = step(env, qpos[:h], qvel[:h], ctrl[:h])
        return torch.cat([q, qpos[h:]]), torch.cat([v, qvel[h:]])

    monkeypatch.setattr(antmaze, "step_physics", half)
    _not_correct(tiny.run("ddiffpg-antmaze-v1.collect"), "obs_gap")


def test_collect_an_action_altered(monkeypatch):
    from ddiffpg_tpu_torch.agents import ddiffpg

    act = ddiffpg.explore_actions

    def altered(*args, **kwargs):
        a = act(*args, **kwargs).clone()
        a[0, 0] = a[0, 0] + (0.5 if a[0, 0] <= 0 else -0.5)
        return a

    monkeypatch.setattr(ddiffpg, "explore_actions", altered)
    _not_correct(tiny.run("ddiffpg-antmaze-v1.collect"), "action_gap")


def _recluster_then(monkeypatch, after):
    from ddiffpg_tpu_torch.replay import episodic as ep

    set_groups = ep.set_groups

    def faulty(buf, group_mask, parent_idx):
        buf = set_groups(buf, group_mask, parent_idx)
        after(buf)
        return buf

    monkeypatch.setattr(ep, "set_groups", faulty)


def test_train_a_stored_slot_left_out_of_the_explore_group(monkeypatch):
    def drop(buf):
        stored = ((buf.traj_id >= 0) & (buf.length > 0)).nonzero()
        buf.group_mask[0, stored[0, 0]] = False

    _recluster_then(monkeypatch, drop)
    _not_correct(tiny.run("ddiffpg-antmaze-v1.train"), "group_gap")


def test_train_target_actions_altered_at_the_recluster(monkeypatch):
    # the synthetic trajectories' raw actions are zeros
    _recluster_then(monkeypatch, lambda buf: buf.target_action.fill_(0.5))
    _not_correct(tiny.run("ddiffpg-antmaze-v1.train"), "loss_gap")
