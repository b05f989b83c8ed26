"""The port's plain DTW wavefront against the JAX package's.

Tracks are made with numpy from a seed. Against JAX's `dtw_batch` and
`dtw_batch_gather` (an XLA float32 scan on the CPU): within 1e-6 relative,
the float32 sums of two compilers over the same cells. Against the float64
`dtw_numpy` DP: within 1e-4 relative, float32 against float64 rounding
accumulated over up to 127 cells of a warping path (tests/test_modes.py's
bound for the JAX kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.ops import dtw as jdtw  # noqa: E402
from ddiffpg_tpu_torch.ops import dtw  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)


def _tracks(seed, n, L, D):
    rng = np.random.RandomState(seed)
    x = np.cumsum(rng.randn(n, L, D), axis=1).astype(np.float32)
    return x, rng


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("L", [1, 7, 64])
def test_dtw_batch_matches_jax_and_numpy(L, D):
    """Pairs of random lengths in 1..L (equal and unequal), plus a pair of
    length-1 tracks and one of lengths 1 and L."""
    P = 12
    A, rng = _tracks(L * 10 + D, P, L, D)
    B, _ = _tracks(L * 10 + D + 1, P, L, D)
    la = rng.randint(1, L + 1, P).astype(np.int32)
    lb = rng.randint(1, L + 1, P).astype(np.int32)
    la[0], lb[0] = 1, 1
    la[1], lb[1] = 1, L
    lb[2] = la[2]
    got = dtw.dtw_batch(torch.tensor(A), torch.tensor(B), torch.tensor(la),
                        torch.tensor(lb)).numpy()
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(A), jnp.asarray(B),
                                     jnp.asarray(la), jnp.asarray(lb)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for k in range(P):
        ref = dtw.dtw_numpy(A[k, :la[k]].astype(np.float64),
                            B[k, :lb[k]].astype(np.float64))
        assert ref == jdtw.dtw_numpy(A[k, :la[k]].astype(np.float64),
                                     B[k, :lb[k]].astype(np.float64))
        np.testing.assert_allclose(got[k], ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("D", [2, 3])
def test_dtw_batch_gather_matches_jax(D):
    """Stacks of unequal row counts, pairs by index (repeats, a track with
    itself), tracks of lengths 1..48 padded to 48."""
    Na, Nb, L, P = 9, 6, 48, 40
    Sa, rng = _tracks(20 + D, Na, L, D)
    Sb, _ = _tracks(30 + D, Nb, L, D)
    la = rng.randint(1, L + 1, Na).astype(np.int32)
    lb = rng.randint(1, L + 1, Nb).astype(np.int32)
    la[0] = 1
    ia = rng.randint(0, Na, P).astype(np.int32)
    ib = rng.randint(0, Nb, P).astype(np.int32)
    ia[:3] = 0
    args_t = [torch.tensor(x) for x in (Sa, Sb, la, lb, ia, ib)]
    got = dtw.dtw_batch_gather(*args_t).numpy()
    plain = dtw.dtw_wavefront(*args_t).numpy()
    want = np.asarray(jdtw.dtw_batch_gather(*(jnp.asarray(x) for x in (
        Sa, Sb, la, lb, ia, ib))))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    same = dtw.dtw_batch_gather(args_t[0], args_t[0], args_t[2], args_t[2],
                                args_t[4], args_t[4]).numpy()
    np.testing.assert_array_equal(same, np.zeros(P, np.float32))


def test_identical_tracks_give_zero_and_bad_inputs_raise():
    x, _ = _tracks(1, 1, 16, 2)
    t = torch.tensor(x)
    n = torch.tensor([16], dtype=torch.int32)
    assert float(dtw.dtw_batch(t, t, n, n)[0]) == 0.0
    assert dtw.dtw_batch(t[:0], t[:0], n[:0], n[:0]).shape == (0,)
    with pytest.raises(ValueError, match="float32"):
        dtw.dtw_batch(t.double(), t.double(), n, n)
    with pytest.raises(ValueError, match="int32"):
        dtw.dtw_batch(t, t, n.long(), n.long())
    with pytest.raises(ValueError, match="L <= 512"):
        long = torch.zeros((1, 513, 2))
        dtw.dtw_batch(long, long, n, n)
