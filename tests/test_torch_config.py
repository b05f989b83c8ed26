"""The port's copy of the config dataclasses against the JAX package's."""

import dataclasses

import pytest

from ddiffpg_tpu import config as jax_config
from ddiffpg_tpu_torch import config

CLASSES = ("NoiseConfig", "ExpConfig", "AlgoConfig", "DiffusionConfig",
           "IntrinsicConfig", "EnvConfig", "Config")


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_field_identical(name):
    """Same fields in the same order, with the same types and defaults."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
        [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
