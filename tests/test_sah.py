"""Binned-SAH treelet builder invariants (models/sah.py)."""

import numpy as np

from torrey.models.sah import (build_sah_treelets,
                                                        validate_treelets)


def _random_boxes(n, seed=0):
    r = np.random.default_rng(seed)
    c = r.uniform(-10, 10, (n, 3))
    h = r.uniform(0.01, 0.5, (n, 3))
    return (c - h).astype(np.float32), (c + h).astype(np.float32)


def test_structure_random():
    mn, mx = _random_boxes(5000)
    t = build_sah_treelets(mn, mx, leaf_size=64)
    validate_treelets(t, mn, mx)
    assert t.num_leaves >= 5000 // 64
    assert np.all(t.leaf_count <= 64)
    assert np.all(t.leaf_count >= 1)
    # preorder: internal node's left child is at n+1, right at skip(n+1)
    internal = t.leaf_of_node < 0
    n = np.arange(t.num_nodes)[internal]
    assert np.all(t.skip[n] > n + 1)


def test_single_prim_and_tiny():
    mn, mx = _random_boxes(1)
    t = build_sah_treelets(mn, mx, leaf_size=8)
    assert t.num_nodes == 1 and t.num_leaves == 1
    mn, mx = _random_boxes(9)
    t = build_sah_treelets(mn, mx, leaf_size=8)
    validate_treelets(t, mn, mx)


def test_degenerate_coincident_centroids():
    # all prims identical: SAH has no valid split; builder must still
    # terminate with balanced halves
    mn = np.zeros((100, 3), np.float32)
    mx = np.ones((100, 3), np.float32)
    t = build_sah_treelets(mn, mx, leaf_size=16)
    validate_treelets(t, mn, mx)
    assert np.all(t.leaf_count <= 16)


def test_sah_beats_slicing_on_clusters():
    """Two far-apart clusters interleaved in index order: SAH must put
    them in different leaves (a Morton slice would too, but an index
    slice would not) and the two leaf boxes must not overlap."""
    r = np.random.default_rng(1)
    a = r.uniform(0, 1, (256, 3))
    b = r.uniform(100, 101, (256, 3))
    c = np.empty((512, 3))
    c[0::2] = a
    c[1::2] = b
    mn = (c - 0.01).astype(np.float32)
    mx = (c + 0.01).astype(np.float32)
    t = build_sah_treelets(mn, mx, leaf_size=256)
    validate_treelets(t, mn, mx)
    assert t.num_leaves == 2
    leaves = np.nonzero(t.leaf_of_node >= 0)[0]
    lo0, hi0 = t.node_min[leaves[0]], t.node_max[leaves[0]]
    lo1, hi1 = t.node_min[leaves[1]], t.node_max[leaves[1]]
    # disjoint along some axis
    assert np.any((hi0 < lo1) | (hi1 < lo0))
