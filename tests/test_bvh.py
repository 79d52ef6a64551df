"""BVH builder invariants + brute-force traversal oracle (SURVEY.md §4c)."""

import numpy as np
import pytest

from torrey.models.bvh import (build_bvh,
                                                        validate_bvh)


@pytest.mark.parametrize("P", [1, 2, 3, 5, 16, 33, 257, 5000])
def test_invariants_random(P):
    rng = np.random.default_rng(P)
    c = rng.uniform(-5, 5, (P, 3))
    h = rng.uniform(0.01, 0.5, (P, 1))
    pmin = (c - h).astype(np.float32)
    pmax = (c + h).astype(np.float32)
    bvh = build_bvh(pmin, pmax)
    assert bvh.num_nodes == 2 * P - 1
    validate_bvh(bvh, pmin, pmax)


def test_invariants_identical_centroids():
    # All prims at the same point (degenerate Morton codes) must still build.
    P = 37
    pmin = np.zeros((P, 3), np.float32)
    pmax = np.ones((P, 3), np.float32)
    bvh = build_bvh(pmin, pmax)
    validate_bvh(bvh, pmin, pmax)


def _host_traverse(bvh, org, d, prim_min, prim_max):
    """Host-side skip-link walk: returns the set of leaf prims whose box the
    ray hits (mirrors the device loop in ops/trace.py, for cross-checking)."""
    hits = set()
    inv = 1.0 / np.where(d == 0, 1e-30, d)
    i = 0
    N = bvh.num_nodes
    while i < N:
        p = bvh.prim[i]
        t0 = (bvh.node_min[i] - org) * inv
        t1 = (bvh.node_max[i] - org) * inv
        tn = np.max(np.minimum(t0, t1))
        tf = np.min(np.maximum(t0, t1))
        hit = tf >= max(0.0, tn)
        if p >= 0:
            if hit:
                hits.add(int(p))
            i = bvh.skip[i]
        else:
            i = i + 1 if hit else bvh.skip[i]
    return hits


def _brute_hits(org, d, prim_min, prim_max):
    inv = 1.0 / np.where(d == 0, 1e-30, d)
    t0 = (prim_min - org) * inv
    t1 = (prim_max - org) * inv
    tn = np.max(np.minimum(t0, t1), axis=-1)
    tf = np.min(np.maximum(t0, t1), axis=-1)
    return set(np.nonzero(tf >= np.maximum(0.0, tn))[0].tolist())


def test_traversal_matches_bruteforce():
    rng = np.random.default_rng(7)
    P = 300
    c = rng.uniform(-5, 5, (P, 3))
    h = rng.uniform(0.05, 0.6, (P, 1))
    pmin = (c - h).astype(np.float32)
    pmax = (c + h).astype(np.float32)
    bvh = build_bvh(pmin, pmax)
    for k in range(50):
        org = rng.uniform(-8, 8, 3).astype(np.float32)
        d = rng.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        got = _host_traverse(bvh, org, d, pmin, pmax)
        want = _brute_hits(org, d, pmin, pmax)
        assert got == want, f"ray {k}: {got ^ want}"


def test_build_speed_large():
    # 200k prims should build in well under 2 s (the reference's recursive
    # builder takes ~10 s for 144k — README.md:123).
    import time
    rng = np.random.default_rng(1)
    P = 200_000
    c = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.1, (P, 1)).astype(np.float32)
    t0 = time.time()
    bvh = build_bvh(c - h, c + h)
    dt = time.time() - t0
    assert bvh.num_nodes == 2 * P - 1
    assert dt < 5.0, f"BVH build too slow: {dt:.2f}s"
