"""A fixture for the port's test files that build models of the JAX package.

The JAX package caches each physics model's tree structure by the model's
`id` (`ddiffpg_tpu/physics/engine.py:_structure`, `_STRUCT_CACHE`). Once a
model is freed, a new model may get its address and with it the freed
model's structure: another scene's bodies, so a Panda env of the new model
indexes past its arrays or steps with another tree. Which freed model
shares an address with which new one depends on everything the process
ran before, so a JAX test can fail after some sequences of test files in
one pytest-xdist worker and pass alone (`test_panda.py::TestEnvs::
test_cabinet_open_success` did so once). The port's test files build and
free many such models; `fresh_structure_cache` empties the cache before
and after each of them, so they neither meet an entry of a freed model
nor leave one behind. The cache only saves recomputing a structure, so
emptying it changes no result.

Use: `from tests.jax_caches import fresh_structure_cache  # noqa: F401`
"""

import pytest
from ddiffpg_tpu.physics import engine


@pytest.fixture(autouse=True, scope="module")
def fresh_structure_cache():
    engine._STRUCT_CACHE.clear()
    yield
    engine._STRUCT_CACHE.clear()
