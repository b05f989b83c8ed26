"""The port's copy of the config dataclasses against the JAX package's."""

import dataclasses

import pytest

from ddiffpg_tpu import config as jax_config
from ddiffpg_tpu_torch import config
from tests.port_fixtures import (  # noqa: F401
    fresh_structure_cache, one_torch_thread)

CLASSES = ("NoiseConfig", "ExpConfig", "AlgoConfig", "DiffusionConfig",
           "IntrinsicConfig", "EnvConfig", "Config")


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_field_identical(name):
    """Same fields in the same order, with the same types and defaults."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
        [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("algo", ["ddiffpg", "AgentDIPO", "diffq", "td3",
                                  "sac"])
def test_algo_preset_identical(algo):
    assert dataclasses.asdict(config.algo_preset(algo)) == \
        dataclasses.asdict(jax_config.algo_preset(algo))


@pytest.mark.parametrize("env,reward", [
    ("antmaze-v1", "sparse"), ("antmaze-v2", "sparse"),
    ("antmaze-v3", "dense"), ("antmaze-v4", "sparse"),
    ("PandaReachJoints-v3", "sparse"), ("PandaReachDense-v3", "dense"),
    ("antmaze-v2-hard", "sparse"), ("antmaze-v5", "dense"),
    ("pointmaze-v1", "sparse"), ("pointmaze-v2-hard", "dense"),
    ("PandaDrawerMulti-v3", "sparse")])
@pytest.mark.parametrize("ddiffpg", [True, False])
def test_preprocess_identical(env, reward, ddiffpg):
    """The per-env overrides and the dense C51 support, as the JAX
    package's preprocess gives them; overrides cast to the field's type."""
    over = {"env.name": env, "env.reward_type": reward,
            "algo.batch_size": 48.0}
    ours = config.preprocess(config.Config().override(**over), ddiffpg)
    theirs = jax_config.preprocess(jax_config.Config().override(**over),
                                   ddiffpg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert isinstance(ours.algo.batch_size, int)
