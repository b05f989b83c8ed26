"""How a port test file (`tests/test_torch_*.py`) sets up its process.

Every port test file but `test_torch_cuda.py` takes both fixtures with

    from tests.port_fixtures import (  # noqa: E402,F401
        fresh_structure_cache, one_torch_thread)

and a new port test file does the same. This module imports nothing of
JAX: some port test files never load it, and the card's machine has none
(`test_torch_slice.py::test_port_runs_without_jax` imports this module in
its JAX-free child).

`fresh_structure_cache`: the JAX package caches each physics model's tree
structure by the model's `id` (`ddiffpg_tpu/physics/engine.py:_structure`,
`_STRUCT_CACHE`). Once a model is freed, a new model may get its address
and with it the freed model's structure: another scene's bodies, so a
Panda env of the new model indexes past its arrays or steps with another
tree. Which freed model shares an address with which new one depends on
everything the process ran before, so a JAX test can fail after some
sequences of test files in one pytest-xdist worker and pass alone
(`test_panda.py::TestEnvs::test_cabinet_open_success` did so once). The
port's test files build and free many such models; the fixture empties
the cache before and after each of them, so they neither meet an entry of
a freed model nor leave one behind. The cache only saves recomputing a
structure, so emptying it changes no result. Where the engine is not
loaded there is no cache to empty.

`one_torch_thread`: the port's tests run small tensors on the CPU, and the
suite runs 6 pytest-xdist workers on 8 cores. At torch's default of one
intra-op thread a core, each worker's threads take the cores of the
others, the JAX ones included, and a test runs about 3x slower in the
suite than alone (`test_torch_update.py::test_train_iter_on_cpu` on an
8-core x86 host with 6 other cores busy: 37.8 s at the default, 7.2 s on
one thread). The
fixture runs the module on one intra-op thread and restores the previous
count after it. `test_torch_cuda.py` keeps the default: on the card it
runs alone, and its CPU reference passes use the cores.
"""

import sys

import pytest
import torch


def _clear_structure_cache():
    engine = sys.modules.get("ddiffpg_tpu.physics.engine")
    if engine is not None:
        engine._STRUCT_CACHE.clear()


@pytest.fixture(autouse=True, scope="module")
def fresh_structure_cache():
    _clear_structure_cache()
    yield
    _clear_structure_cache()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
