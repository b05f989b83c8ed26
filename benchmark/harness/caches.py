"""Build and kernel caches at fixed paths inside the checkout.

The port builds its CUDA and C++ libraries into `build/torch_ext/` of the
checkout (content-hashed). Every other compile cache a library of the run
could use is pinned here, before torch is imported, under
`build/bench_cache/`, so that only the first run of a cell in a checkout
builds anything. The host's math libraries get one thread each.
"""

from __future__ import annotations

import os
from pathlib import Path


def pin(root: Path):
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # no library of the run may load JAX on its own
    os.environ["USE_FLAX"] = "0"
    # one thread of host math: no OpenMP pool spinning beside the loop
    # that launches the card's work
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
