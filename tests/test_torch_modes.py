"""The port's mode discovery against the JAX package's: linkage (native and
numpy), flat clusters, the Q-scheduler's plans and ClusterManager.recluster.

The inputs are made with numpy from a seed and go through both packages
on the CPU. Linkage: the same merge order exactly and heights within
1e-12 (both sum the Lance-Williams update in float64 in one order).
fcluster labels, scheduler plans and recluster results (clusters, group
masks, evictions, plan, goal counts) must be identical; the recluster's
linkage heights agree within 1e-6 relative (the DTW distances are float32
wavefronts in two frameworks, tests/test_torch_dtw.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu.modes import cluster as jcluster  # noqa: E402
from ddiffpg_tpu.modes import linkage as jlinkage  # noqa: E402
from ddiffpg_tpu.modes.q_scheduler import QScheduler as JQScheduler  # noqa
from ddiffpg_tpu_torch.modes import _native  # noqa: E402
from ddiffpg_tpu_torch.modes import cluster, linkage  # noqa: E402
from ddiffpg_tpu_torch.modes.q_scheduler import QScheduler  # noqa: E402
from ddiffpg_tpu_torch.utils import convert  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)


def _dist(seed, n=40, blobs=1):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.randn(n // blobs, 2) + 8 * b
                          for b in range(blobs)])
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("seed,n,blobs", [(2, 40, 1), (3, 30, 2), (4, 2, 1),
                                          (5, 65, 3)])
def test_linkage_matches_jax(impl, seed, n, blobs):
    D = _dist(seed, n, blobs)
    fn = linkage.linkage_average if impl == "native" else \
        linkage._linkage_average_numpy
    got = fn(D)
    want = jlinkage._linkage_average_numpy(D)
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-12)


def test_native_library_builds_from_the_checkout():
    """The port's linkage runs its own build of csrc/cluster.cpp; a single
    point has no merge."""
    path = _native.build()
    assert path.exists() and path.parent.name == "torch_ext"
    assert linkage.linkage_average(np.zeros((1, 1))).shape == (0, 4)


@pytest.mark.parametrize("thr", [2.0, 5.0, None])
def test_fcluster_matches_jax(thr):
    D = _dist(3, 30, 2)
    Z = linkage.linkage_average(D)
    t = 0.7 * Z[:, 2].max() if thr is None else thr
    np.testing.assert_array_equal(
        linkage.fcluster_distance(Z, len(D), t),
        jlinkage.fcluster_distance(Z, len(D), t))


SCRIPTS = {
    "fresh": [[[1, 2], [3, 4]]],
    "inherit_and_clone": [[[1, 2, 3], [10, 11, 12]],
                          [[1, 2], [3], [10, 11, 12]]],
    "larger_overlap_keeps_embedding": [[[1, 2, 3, 4], [9]],
                                       [[1], [2, 3, 4], [9]]],
    "no_overlap": [[[1, 2]], [[99, 100]]],
    "empty_then_modes": [[], [[5, 6]], [[5, 6, 7], [8]], []],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_q_scheduler_plans_match_jax(name):
    got, want = QScheduler(max_groups=11), JQScheduler(max_groups=11)
    for clusters in SCRIPTS[name]:
        p, q = got.update_cluster(clusters), want.update_cluster(clusters)
        for f in dataclasses.fields(p):
            np.testing.assert_array_equal(getattr(p, f.name),
                                          getattr(q, f.name), err_msg=f.name)
        assert got.last_cluster == want.last_cluster


def _bundles(rng, S, L, n, succ, base=lambda k: 50.0 * (k % 2), scale=1.0):
    """Recluster inputs: n stored trajectories of length L in S slots,
    random walks of step `scale` from the point base(k) (well-separated
    bundles)."""
    traj_id = np.full(S, -1, np.int64)
    traj_id[:n] = np.arange(n)
    length = np.zeros(S, np.int64)
    length[:n] = L
    tracks = np.zeros((S, L, 2), np.float32)
    for k in range(n):
        tracks[k] = base(k) + scale * np.cumsum(
            rng.randn(L, 2), 0)
    return traj_id, length, np.asarray(succ, np.int64), tracks


def _check_same(res, jres):
    for f in ("num_groups", "goal_counts", "clusters", "unsuccess_clusters",
              "plot_clusters", "plot_unsuccess_clusters"):
        assert getattr(res, f) == getattr(jres, f), f
    np.testing.assert_array_equal(res.group_mask, jres.group_mask)
    np.testing.assert_array_equal(res.evict_slots, jres.evict_slots)
    for f in dataclasses.fields(res.plan):
        np.testing.assert_array_equal(getattr(res.plan, f.name),
                                      getattr(jres.plan, f.name))
    if jres.Z is None:
        assert res.Z is None
    else:
        np.testing.assert_array_equal(res.Z[:, [0, 1, 3]],
                                      jres.Z[:, [0, 1, 3]])
        np.testing.assert_allclose(res.Z[:, 2], jres.Z[:, 2], rtol=1e-6)


def _pair(**kw):
    return (cluster.ClusterManager(device="cpu", **kw),
            jcluster.ClusterManager(**kw))


def test_cache_pruned_to_live_ids():
    """tests/test_modes.py's generations of all-new ids: both managers
    give the same result each time, and the port's cache holds live ids
    only, as the JAX one's."""
    cm, jcm = _pair(capacity=64, max_modes=4, threshold=25.0)
    for gen in range(4):
        rng = np.random.RandomState(gen * 6 + 1)
        succ = np.zeros(8, np.int64)
        succ[:6] = 1
        args = _bundles(rng, 8, 12, 6, succ)
        args[0][:6] += gen * 6
        _check_same(cm.recluster(*args), jcm.recluster(*args))
        assert set(cm.cache) == set(jcm.cache)
        assert all(a in set(args[0][:6]) for a, _ in cm.cache)
        assert len(cm.cache) <= 6 * 5 * 2


SPLIT_CASES = {  # (threshold, max_modes, split_by_goal)
    "split": (1e6, 4, True),
    "global_merge": (1e6, 4, False),
    "collapse_per_goal": (1e-6, 3, True),
    "collapse_all": (1e-6, 3, False),
    "threshold_from_heights": (None, 4, False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_recluster_split_and_collapse_match_jax(case):
    """tests/test_modes.py's goal-stratified scenarios: four goal-2 and two
    goal-1 successes in two bundles, plus two failures."""
    thr, max_modes, split = SPLIT_CASES[case]
    rng = np.random.RandomState(0)
    succ = np.zeros(12, np.int64)
    succ[:4], succ[4:6] = 2, 1
    traj_id, length, success, tracks = _bundles(
        rng, 12, 16, 8, succ, base=lambda k: 0.0 if k < 4 else 50.0,
        scale=0.1)
    cm, jcm = _pair(capacity=64, max_modes=max_modes, threshold=thr,
                    split_by_goal=split)
    res = cm.recluster(traj_id, length, success, tracks)
    _check_same(res, jcm.recluster(traj_id, length, success, tracks))
    if split:
        for cl in res.clusters:
            assert len({success[t] for t in cl}) == 1


@pytest.mark.parametrize("protected", [[], [5, 9, 13]])
def test_recluster_eviction_and_protection_match_jax(protected):
    """tests/test_modes.py's frontier case: 2 successes, 20 failures and a
    capacity that forces the balanced evictions; protected slots are never
    evicted, and the random draws (random.Random(seed)) agree."""
    rng = np.random.RandomState(1)
    succ = np.zeros(24, np.int64)
    succ[:2] = 1
    args = _bundles(rng, 24, 16, 22, succ, base=lambda k: 0.0, scale=0.1)
    cm, jcm = _pair(capacity=12, max_modes=4, threshold=1e6, seed=3)
    res = cm.recluster(*args, protect_slots=protected or None)
    _check_same(res, jcm.recluster(*args, protect_slots=protected or None))
    assert len(res.evict_slots) > 0
    assert not set(protected) & set(res.evict_slots.tolist())


def test_recluster_unequal_lengths_downsampling_and_carry():
    """Tracks of unequal lengths (some longer than dtw_max_len, so they
    are downsampled), then a second recluster from a manager whose cache,
    scheduler and random state were carried from the JAX one
    (`convert.cluster_state`)."""
    rng = np.random.RandomState(7)
    S, L = 16, 40
    succ = np.array([1] * 8 + [0] * 4 + [0] * 4, np.int64)
    traj_id, length, success, tracks = _bundles(rng, S, L, 12, succ,
                                                scale=0.3)
    length[:12] = rng.randint(3, L + 1, 12)
    for use_downsampling in (False, True):
        cm, jcm = _pair(capacity=64, max_modes=4, threshold=None,
                        dtw_max_len=32, use_downsampling=use_downsampling)
        _check_same(cm.recluster(traj_id, length, success, tracks),
                    jcm.recluster(traj_id, length, success, tracks))
    # new ids in four slots; the carried manager only computes new pairs
    traj_id[12:16] = np.arange(12, 16)
    length[12:16] = L
    success[12:14] = 1
    fresh = convert.cluster_state(cluster.ClusterManager(
        capacity=64, max_modes=4, device="cpu", dtw_max_len=32,
        use_downsampling=True), jcm)
    _check_same(fresh.recluster(traj_id, length, success, tracks),
                jcm.recluster(traj_id, length, success, tracks))
    assert 0 < fresh.dtw_stats["pairs"] < 16 * 15
