"""The CUDA DTW kernel's arithmetic on the CPU, and its launch geometry.

`csrc/dtw.cu` compiles as host C++ with `-DDTW_HOST`: the CUDA qualifiers
are empty, a warp's 32 lanes run each step of the column wavefront in
turn, and `__shfl_up_sync` is an array that every lane writes before any
lane reads (the card's lanes run a step together and exchange through the
shuffle). Built with `g++ -O1 -ffp-contract=off` (no contraction, as the
card's `-fmad=false`), the DP's terminal cells D[la-1, lb-1] must equal
the plain PyTorch wavefront's (`ops/dtw.py:dtw_terminal`) bit for bit, for
every template of rows a lane that fits the length, and a NaN point must
give NaN, as the plain version and the JAX package's `dtw_batch_gather`
give. The distances are the cells' `sqrtf`, rounded correctly as on the
card; PyTorch's CPU `sqrt` (its AVX-512 vector path) may miss by an ulp,
so against `dtw_wavefront` on the CPU they are within one ulp.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.ops import dtw as jdtw  # noqa: E402
from ddiffpg_tpu_torch.ops import dtw, dtw_cuda  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = tmp_path_factory.mktemp("dtw_host") / "dtw_host.so"
    cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
           "-fPIC", "-DDTW_HOST", "-x", "c++", str(dtw_cuda.SOURCE), "-o",
           str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    dll.dtw_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    dll.dtw_host.restype = ctypes.c_int
    return dll


def _host(lib, args, R):
    """(distances, terminal cells) of the host build with R rows a lane."""
    arrs = [np.ascontiguousarray(a) for a in args]
    P, (L, D) = arrs[4].shape[0], arrs[0].shape[1:]
    out, cells = np.full(P, -1.0, np.float32), np.full(P, -1.0, np.float32)
    assert lib.dtw_host(*(a.ctypes.data for a in arrs), out.ctypes.data,
                        cells.ctypes.data, P, L, D, R) == 0
    return out, cells


def _plain(args):
    """(distances, terminal cells) of the plain wavefront on the CPU."""
    t = [torch.tensor(a) for a in args]
    return (dtw.dtw_wavefront(*t).numpy(), dtw.dtw_terminal(*t).numpy())


def _bits(x):
    return x.view(np.int32)


def _inputs(L, D, seed):
    """Two different stacks of unequal row counts (random walks), lengths
    1..L with la != lb, lb = 1, la = 1, both L, a track against itself;
    and a track stalled at one point against one that leaves it for a
    30-point detour near its end (at L >= 64 all 32 lanes hold rows: a
    lane that read a wrong neighbour's cell could skip the detour)."""
    rng = np.random.RandomState(seed)
    Na, Nb, P = 7, 5, 14
    sa = np.cumsum(rng.randn(Na, L, D), axis=1).astype(np.float32)
    sb = np.cumsum(rng.randn(Nb, L, D), axis=1).astype(np.float32)
    la = rng.randint(1, L + 1, Na).astype(np.int32)
    lb = rng.randint(1, L + 1, Nb).astype(np.int32)
    la[:3], lb[:3] = (L, 1, max(1, L - 1)), (1, L, L)
    ia = rng.randint(0, Na, P).astype(np.int32)
    ib = rng.randint(0, Nb, P).astype(np.int32)
    ia[:4], ib[:4] = (0, 1, 2, 0), (0, 1, 2, 2)
    if L >= 64:
        sa[-1] = sa[-1, :1]
        sb[-1] = sa[-1, :1]
        sb[-1, L - 33: L - 3] += 50.0
        la[-1] = lb[-1] = L
        ia[4], ib[4] = Na - 1, Nb - 1
    return sa, sb, la, lb, ia, ib


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, 64, 500, 512])
def test_host_kernel_bitwise_plain(host_lib, L, D):
    args = _inputs(L, D, 10 * L + D)
    want, want_cells = _plain(args)
    assert np.isfinite(want_cells).all()
    R0 = dtw_cuda.launch_geometry(L, D)[1]
    for R in [r for r in dtw_cuda.ROWS if r >= R0]:
        got, cells = _host(host_lib, args, R)
        np.testing.assert_array_equal(_bits(cells), _bits(want_cells),
                                      err_msg=f"R={R}")
        np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(cells)))
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # one track of each stack against itself
    same = (args[0], args[0], args[2], args[2], args[4], args[4])
    assert (_host(host_lib, same, R0)[0] == 0).all()


def test_host_kernel_nan_point_gives_nan(host_lib):
    """One NaN coordinate in a 40-point track: NaN for every pair that
    holds that track, as the plain version and JAX give; the rest finite
    and bitwise the plain version's."""
    L, D = 40, 2
    rng = np.random.RandomState(3)
    stack = np.cumsum(rng.randn(3, L, D), axis=1).astype(np.float32)
    stack[0, 17, 1] = np.nan
    lens = np.array([L, 33, 1], np.int32)
    ia = np.array([0, 1, 1, 2, 0, 2], np.int32)
    ib = np.array([1, 0, 1, 0, 2, 1], np.int32)
    args = (stack, stack, lens, lens, ia, ib)
    want_nan = np.array([True, True, False, True, True, False])
    jax_d = np.asarray(jdtw.dtw_batch_gather(*(jnp.asarray(a)
                                                for a in args)))
    plain, plain_cells = _plain(args)
    np.testing.assert_array_equal(np.isnan(jax_d), want_nan)
    np.testing.assert_array_equal(np.isnan(plain), want_nan)
    for R in (2, 16):
        got, cells = _host(host_lib, args, R)
        np.testing.assert_array_equal(np.isnan(got), want_nan)
        np.testing.assert_array_equal(_bits(cells[~want_nan]),
                                      _bits(plain_cells[~want_nan]))


def test_launch_geometry_and_refusals(host_lib):
    """R is the least template with 32 R >= L; each warp's shared copy of
    b is L x D floats. The host entry refuses what the card's launch
    refuses: R too small for L, L or D out of range."""
    want = {1: 1, 32: 1, 33: 2, 64: 2, 65: 4, 128: 4, 129: 8, 256: 8,
            257: 16, 500: 16, 512: 16}
    for L, R in want.items():
        warps, got_R, shared = dtw_cuda.launch_geometry(L, 3)
        assert got_R == R and shared == warps * 3 * L * 4
        assert 1 <= warps <= host_lib.dtw_max_warps()
    assert host_lib.dtw_max_len() == dtw.MAX_LEN
    assert host_lib.dtw_max_dim() == dtw.MAX_DIM
    args = _inputs(64, 2, 1)
    assert host_lib.dtw_host(*(np.ascontiguousarray(a).ctypes.data
                               for a in args), 0, 0, 1, 64, 2, 1) == 1
    for L, D in ((513, 2), (64, 4), (64, 0)):
        assert host_lib.dtw_host(0, 0, 0, 0, 0, 0, 0, 0, 1, L, D, 16) == 1
