"""The frozen counts: the model-FLOP function against the port's layer
shapes at each configuration's widths, and the substep op count against
the frozen plain substep."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import flops, substep_bound

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = sorted((ROOT / "benchmark" / "configs").glob("*.json"))


def _linear_macs(module) -> int:
    """Multiply-adds of one row through every nn.Linear of `module`."""
    return sum(m.in_features * m.out_features for m in module.modules()
               if isinstance(m, torch.nn.Linear))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_flops_follow_the_ports_layers(path):
    from ddiffpg_tpu_torch.intrinsic import IntrinsicModule
    from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy
    from ddiffpg_tpu_torch.models.mlp import DistributionalDoubleQ

    f = json.loads(path.read_text())
    w, c = f["widths"], f["config"]
    actor = DiffusionPolicy(w["action_dim"],
                            w["obs_dim"] + w["embedding_dim"],
                            w["diffusion_iter"], device="cpu")
    assert flops.actor_macs(w) == _linear_macs(actor)
    critics = DistributionalDoubleQ(w["obs_dim"], w["action_dim"],
                                    w["critic_rows"], w["num_atoms"])
    per_row = sum(x[0].numel() for x in critics.weight)   # [2, in, out]
    assert flops.critic_macs(w) == per_row
    intr = IntrinsicModule(w["obs_dim"], pos_dim=w["pos_dim"],
                           L=w["posenc_L"]).init("cpu")
    assert 2 * flops.rnd_net_macs(w) == _linear_macs(intr.net)
    assert w["critic_rows"] == c["algo"]["max_modes"] + 1
    assert w["num_atoms"] == c["algo"]["num_atoms"]
    assert w["embedding_dim"] == c["algo"]["embedding_dim"]
    assert w["diffusion_iter"] == c["diffusion"]["diffusion_iter"]
    assert w["posenc_L"] == c["intrinsic"]["L"]


def test_a_train_pass_at_three_groups():
    f = json.loads((ROOT / "benchmark/configs/ddiffpg-antmaze-v1.json")
                   .read_text())
    w = f["widths"]
    assert flops.act_flops(w) == pytest.approx(14.87e6, rel=1e-3)
    assert flops.update_pass_flops(w, f["config"], 3) == pytest.approx(
        255.7e9, rel=5e-3)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_substep_count_is_frozen(path):
    from benchmark.reference import follow

    f = json.loads(path.read_text())
    cfg = follow.config(f["config"], 64, 0)
    env = follow.make_env(cfg, 64, torch.device("cpu"), 0).env
    sub = f["substep"]
    assert (env.consts.nq, env.consts.nv, env.consts.nu,
            env.consts.n_substeps) == (sub["nq"], sub["nv"], sub["nu"],
                                       sub["n_substeps"])
    for seed in (0, 1):
        assert substep_bound.count_row_ops(env, 64, seed) == \
            sub["row_ops_per_env_substep"]


def test_substep_bounds_at_4096_envs():
    """PERF.md's kernel table: 0.04353 ms for the ant, 0.02418 ms for
    DrawerMulti, both set by the operations."""
    for name, want in (("ddiffpg-antmaze-v1", 0.04353),
                       ("ddiffpg-drawermulti-joints", 0.02418)):
        f = json.loads((ROOT / "benchmark/configs" / f"{name}.json")
                       .read_text())
        ms, by = substep_bound.bound_ms(f["substep"], 4096)
        assert ms == pytest.approx(want, abs=5e-6) and by == "operations"
