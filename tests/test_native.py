"""Native C++ BVH builder: availability, bit-parity with numpy, speed."""

import time

import numpy as np
import pytest

from torrey.models import native
from torrey.models.bvh import build_bvh, validate_bvh


def _random_boxes(P, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.5, (P, 3)).astype(np.float32)
    return centers - half, centers + half


needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native lib unavailable")


@needs_native
@pytest.mark.parametrize("P", [2, 3, 7, 100, 4096, 50001])
def test_native_matches_numpy_bitwise(P):
    pmin, pmax = _random_boxes(P, seed=P)
    a = build_bvh(pmin, pmax, use_native=False)
    b = build_bvh(pmin, pmax, use_native=True)
    np.testing.assert_array_equal(a.skip, b.skip)
    np.testing.assert_array_equal(a.prim, b.prim)
    np.testing.assert_array_equal(a.node_min, b.node_min)
    np.testing.assert_array_equal(a.node_max, b.node_max)
    assert a.depth == b.depth


@needs_native
def test_native_validates():
    pmin, pmax = _random_boxes(20000, seed=1)
    bvh = build_bvh(pmin, pmax, use_native=True)
    validate_bvh(bvh, pmin, pmax)


@needs_native
def test_native_is_faster_at_scale():
    pmin, pmax = _random_boxes(400000, seed=2)
    t0 = time.perf_counter()
    build_bvh(pmin, pmax, use_native=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_bvh(pmin, pmax, use_native=False)
    t_numpy = time.perf_counter() - t0
    # the C++ builder must at least keep pace; in practice it is ~2-10x
    # faster than the numpy level-sweep at this scale
    assert t_native < t_numpy * 1.5, (t_native, t_numpy)


@needs_native
@pytest.mark.parametrize("P,leaf", [(1, 512), (100, 16), (20000, 64),
                                    (50001, 512)])
def test_native_sah_matches_numpy_bitwise(P, leaf):
    """C++ binned-SAH treelets == numpy reference, field for field
    (same numerics, stable partition, first-min tie-breaks)."""
    from torrey.models import sah
    pmin, pmax = _random_boxes(P, seed=P + 7)
    a = sah._build_sah_treelets_numpy(pmin, pmax, leaf_size=leaf)
    b_t = native.build_sah_treelets_native(pmin, pmax, leaf)
    assert b_t is not None
    b = sah.SAHTreelets(node_min=b_t[0], node_max=b_t[1], skip=b_t[2],
                        leaf_of_node=b_t[3], order=b_t[4],
                        leaf_start=b_t[5], leaf_count=b_t[6], depth=b_t[7])
    for f in ("node_min", "node_max", "skip", "leaf_of_node", "order",
              "leaf_start", "leaf_count"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.depth == b.depth
    sah.validate_treelets(b, pmin, pmax)


@needs_native
def test_native_sah_is_faster_at_scale():
    from torrey.models import sah
    pmin, pmax = _random_boxes(400000, seed=11)
    t0 = time.perf_counter()
    nat = native.build_sah_treelets_native(pmin, pmax, 512)
    t_native = time.perf_counter() - t0
    assert nat is not None
    t0 = time.perf_counter()
    sah._build_sah_treelets_numpy(pmin, pmax, 512)
    t_numpy = time.perf_counter() - t0
    assert t_native < t_numpy, (t_native, t_numpy)
