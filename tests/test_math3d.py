"""Unit tests for the host math foundation (utils/math3d)."""

import numpy as np
import pytest

from torrey.utils import math3d as m3


def test_translate_scale_rotate_compose():
    p = np.array([1.0, 2.0, 3.0])
    assert np.allclose(m3.xform_point(m3.translate((1, 0, -1)), p), [2, 2, 2])
    assert np.allclose(m3.xform_point(m3.scale((2, 3, 4)), p), [2, 6, 12])
    # 90 deg about z: x -> y
    r = m3.rotate(90.0, (0, 0, 1))
    assert np.allclose(m3.xform_point(r, [1, 0, 0]), [0, 1, 0], atol=1e-6)


def test_rotate_matches_reference_convention():
    # rotate(angle, axis) about +y by 90: +z -> +x (right-handed,
    # reference transform.cpp:20-45)
    r = m3.rotate(90.0, (0, 1, 0))
    assert np.allclose(m3.xform_point(r, [0, 0, 1]), [1, 0, 0], atol=1e-6)


def test_look_at_columns():
    m = m3.look_at([1, 2, 3], [1, 2, 4], [0, 1, 0])
    # dir = +z, left = cross(up, dir) = +x... cross((0,1,0),(0,0,1)) = (1,0,0)
    assert np.allclose(m[:3, 2], [0, 0, 1])
    assert np.allclose(m[:3, 0], [1, 0, 0])
    assert np.allclose(m[:3, 3], [1, 2, 3])


def test_xform_normal_inverse_transpose():
    # Non-uniform scale: normal of a plane must use inverse-transpose.
    s = m3.scale((2, 1, 1))
    n = m3.xform_normal(m3.inverse(s), np.array([1.0, 1.0, 0.0]))
    v = m3.xform_vector(s, np.array([1.0, -1.0, 0.0]))  # tangent transformed
    assert abs(np.dot(n, v)) < 1e-6
    assert abs(np.linalg.norm(n) - 1) < 1e-6


def test_xform_point_batched():
    pts = np.random.default_rng(0).normal(size=(17, 3))
    m = m3.rotate(33.0, (1, 2, 3)) @ m3.translate((4, 5, 6))
    one_by_one = np.stack([m3.xform_point(m, p) for p in pts])
    assert np.allclose(m3.xform_point(m, pts), one_by_one, atol=1e-5)


def test_srgb_to_rgb():
    assert np.allclose(m3.srgb_to_rgb(np.array([0.0, 0.04045, 1.0])),
                       [0.0, 0.04045 / 12.92, 1.0], atol=1e-6)


def test_compute_vertex_normals_flat_quad():
    # Two triangles forming a flat quad in z=0 -> all normals (0,0,1)
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    n = m3.compute_vertex_normals(pos, idx)
    assert np.allclose(n, [[0, 0, 1]] * 4, atol=1e-6)


def test_compute_vertex_normals_angle_weighted():
    # A vertex shared by two orthogonal faces with equal corner angles gets
    # the bisector direction.
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    idx = np.array([[0, 1, 3], [0, 3, 2]])  # face normals +z and -x
    n = m3.compute_vertex_normals(pos, idx)
    # equal 45-degree corner angles at vertex 3 -> bisector of (0,0,1),(-1,0,0)
    assert np.allclose(n[3], np.array([-1, 0, 1]) / np.sqrt(2), atol=1e-5)


def test_degenerate_face_ignored():
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    idx = np.array([[0, 1, 2], [0, 1, 3]])  # first face degenerate
    n = m3.compute_vertex_normals(pos, idx)
    assert np.allclose(n[0], [0, 0, 1], atol=1e-6)
    assert not np.any(np.isnan(n))
