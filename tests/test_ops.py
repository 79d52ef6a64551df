"""Unit tests for device-side ops: geometry kernels, RNG, BRDFs, camera
(SURVEY.md §4a/§4c test strategy).  All device math is SoA (ops/vec.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torrey.ops import brdf, geometry as g, rng
from torrey.ops.camera import (Camera,
                                                        camera_ray_data,
                                                        generate_primary_rays)
from torrey.ops.vec import Vec3, dot, normalize


def v3(*pts):
    """list of 3-tuples -> Vec3 of [N] arrays."""
    a = np.asarray(pts, np.float32)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                jnp.asarray(a[:, 2]))


def vnp(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_sphere_intersection_basic():
    t, hit = g.intersect_sphere(v3((0, 0, -3)), jnp.array([0.5]),
                                v3((0, 0, 0)), v3((0, 0, -1)), 0.0, g.INF)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(2.5, abs=1e-5)


def test_sphere_from_inside_picks_far_root():
    t, hit = g.intersect_sphere(v3((0, 0, 0)), jnp.array([2.0]),
                                v3((0, 0, 0)), v3((0, 0, 1)), 1e-4, g.INF)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(2.0, abs=1e-5)


def test_sphere_behind_misses():
    _t, hit = g.intersect_sphere(v3((0, 0, 5)), jnp.array([1.0]),
                                 v3((0, 0, 0)), v3((0, 0, -1)), 0.0, g.INF)
    assert not bool(hit[0])


def test_triangle_intersection_barycentric():
    t, u, v, hit = g.intersect_triangle(
        v3((0, 0, -2)), v3((1, 0, 0)), v3((0, 1, 0)),
        v3((0.25, 0.25, 0)), v3((0, 0, -1)), 0.0, g.INF)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(2.0, abs=1e-6)
    assert float(u[0]) == pytest.approx(0.25, abs=1e-6)
    assert float(v[0]) == pytest.approx(0.25, abs=1e-6)


def test_triangle_edge_cases():
    # outside the triangle
    *_, hit = g.intersect_triangle(
        v3((0, 0, -2)), v3((1, 0, 0)), v3((0, 1, 0)),
        v3((0.75, 0.75, 0)), v3((0, 0, -1)), 0.0, g.INF)
    assert not bool(hit[0])
    # parallel ray
    *_, hit = g.intersect_triangle(
        v3((0, 0, -2)), v3((1, 0, 0)), v3((0, 1, 0)),
        v3((0.25, 0.25, 0)), v3((1, 0, 0)), 0.0, g.INF)
    assert not bool(hit[0])


def test_slab_test():
    org = v3((0, 0, 0))
    bmin = v3((-1, -1, -3))
    bmax = v3((1, 1, -2))
    inv = Vec3(1.0 / jnp.array([1e-9]), 1.0 / jnp.array([1e-9]),
               1.0 / jnp.array([-1.0]))
    assert bool(g.slab_test(org, inv, bmin, bmax, jnp.inf)[0])
    inv2 = Vec3(inv.x, inv.y, 1.0 / jnp.array([1.0]))
    assert not bool(g.slab_test(org, inv2, bmin, bmax, jnp.inf)[0])
    assert not bool(g.slab_test(org, inv, bmin, bmax, jnp.float32(1.0))[0])


def test_frame_orthonormal():
    rngv = np.random.default_rng(0)
    nn = rngv.normal(size=(100, 3))
    nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
    n = v3(*[tuple(p) for p in nn])
    x, y = g.make_frame(n)
    assert np.allclose(np.asarray(dot(x, y)), 0, atol=1e-5)
    assert np.allclose(np.asarray(dot(x, n)), 0, atol=1e-5)
    assert np.allclose(np.asarray(dot(x, x)), 1, atol=1e-5)
    assert np.allclose(np.asarray(dot(y, y)), 1, atol=1e-5)
    # degenerate -z normal still yields a valid ONB (Duff et al. branchless)
    x, y = g.make_frame(v3((0, 0, -1)))
    np.testing.assert_allclose(vnp(x)[0], [1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(vnp(y)[0], [0, -1, 0], atol=1e-5)


def test_reflect():
    from torrey.ops.vec import reflect
    n = v3((0, 0, 1))
    wi = normalize(v3((1, 0, 1)))
    r = reflect(wi, n)
    np.testing.assert_allclose(vnp(r)[0], vnp(normalize(v3((-1, 0, 1))))[0],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# RNG
# ---------------------------------------------------------------------------

def test_rng_uniformity_and_decorrelation():
    R = 200_000
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    st, u1 = rng.next_uniform(st)
    st, u2 = rng.next_uniform(st)
    a = np.asarray(u1)
    b = np.asarray(u2)
    assert 0.0 <= a.min() and a.max() < 1.0
    assert abs(a.mean() - 0.5) < 2e-3
    assert abs(np.corrcoef(a, b)[0, 1]) < 5e-3
    st2 = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 1)
    _, v1 = rng.next_uniform(st2)
    assert abs(np.corrcoef(a, np.asarray(v1))[0, 1]) < 5e-3


def test_rng_deterministic():
    st = rng.seed_rays(jnp.arange(64, dtype=jnp.uint32), 7, seed=42)
    _, u = rng.next_uniform(st)
    st2 = rng.seed_rays(jnp.arange(64, dtype=jnp.uint32), 7, seed=42)
    _, u2 = rng.next_uniform(st2)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))


# ---------------------------------------------------------------------------
# sampling distributions
# ---------------------------------------------------------------------------

def test_cos_hemisphere_distribution():
    R = 400_000
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    st, u1, u2 = rng.next_uniform2(st)
    w = g.sample_cos_hemisphere(u1, u2)
    wz = np.asarray(w.z)
    assert np.all(wz >= 0)
    assert np.allclose(np.asarray(dot(w, w)), 1, atol=1e-4)
    assert abs(wz.mean() - 2 / 3) < 3e-3  # E[cos] = 2/3 for pdf = cos/pi


def test_cos_n_hemisphere_distribution():
    R = 400_000
    exponent = 20.0
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 3)
    st, u1, u2 = rng.next_uniform2(st)
    w = g.sample_cos_n_hemisphere(u1, u2, jnp.float32(exponent))
    assert abs(np.asarray(w.z).mean() - (exponent + 1) / (exponent + 2)) < 3e-3


# ---------------------------------------------------------------------------
# BRDFs
# ---------------------------------------------------------------------------

def _mat(mtype, color, param=0.0, R=1):
    ones = jnp.ones((R,), jnp.float32)
    return brdf.MatLookup(
        mtype=jnp.full((R,), mtype, jnp.int32),
        color=Vec3(color[0] * ones, color[1] * ones, color[2] * ones),
        param=jnp.full((R,), param, jnp.float32))


def _tile(vec, R):
    return Vec3(jnp.broadcast_to(vec.x, (R,)), jnp.broadcast_to(vec.y, (R,)),
                jnp.broadcast_to(vec.z, (R,)))


def test_diffuse_eval_matches_formula():
    mat = _mat(0, [0.8, 0.6, 0.4])
    n = v3((0, 0, 1))
    wi = normalize(v3((0.3, 0.1, 0.9)))
    wo = normalize(v3((0.2, -0.4, 0.8)))
    ev = brdf.eval_brdf(mat, n, wi, wo)
    cos = float(wo.z[0])
    np.testing.assert_allclose(vnp(ev.value)[0],
                               np.array([0.8, 0.6, 0.4]) * cos / np.pi,
                               rtol=1e-5)
    assert float(ev.pdf[0]) == pytest.approx(cos / np.pi, rel=1e-5)


def test_sample_eval_consistency_diffuse():
    R = 100_000
    mat = _mat(0, [0.7, 0.7, 0.7], R=R)
    n = _tile(v3((0, 0, 1)), R)
    wi = _tile(normalize(v3((0.2, 0.3, 0.93))), R)
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    samp = brdf.sample_brdf(mat, n, wi, st)
    ev = brdf.eval_brdf(mat, n, wi, samp.wo)
    pdf = np.asarray(ev.pdf)
    ok = pdf > 1e-6
    ratio = vnp(ev.value)[ok] / pdf[ok, None]
    np.testing.assert_allclose(ratio, 0.7, rtol=1e-3)


def test_phong_pdf_integrates_to_one():
    R = 2_000_000
    exponent = 10.0
    rv = np.random.default_rng(1)
    d = rv.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[d[:, 2] > 0]
    m = d.shape[0]
    mat = _mat(3, [1, 1, 1], exponent, R=m)
    n = _tile(v3((0, 0, 1)), m)
    wi = _tile(v3((0, 0, 1)), m)
    wo = Vec3(jnp.asarray(d[:, 0], jnp.float32),
              jnp.asarray(d[:, 1], jnp.float32),
              jnp.asarray(d[:, 2], jnp.float32))
    ev = brdf.eval_brdf(mat, n, wi, wo)
    integral = np.asarray(ev.pdf).mean() * 2 * np.pi
    assert integral == pytest.approx(1.0, abs=0.02)


def test_mirror_is_pure_specular_with_fresnel_weight():
    from torrey.ops.vec import reflect
    mat = _mat(1, [0.9, 0.8, 0.7])
    n = v3((0, 0, 1))
    wi = normalize(v3((0, 0.6, 0.8)))
    st = rng.seed_rays(jnp.arange(1, dtype=jnp.uint32), 0)
    samp = brdf.sample_brdf(mat, n, wi, st)
    assert bool(samp.is_pure_specular[0])
    wo = vnp(samp.wo)[0]
    np.testing.assert_allclose(wo, vnp(reflect(wi, n))[0], atol=1e-6)
    cos = wo @ np.array([0, 0, 1.0])
    f_expect = np.array([0.9, 0.8, 0.7]) + \
        (1 - np.array([0.9, 0.8, 0.7])) * (1 - cos) ** 5
    np.testing.assert_allclose(vnp(samp.weight)[0], f_expect, rtol=1e-5)


def test_plastic_lobe_probabilities():
    R = 200_000
    eta = 1.5
    mat = _mat(2, [0.5, 0.5, 0.5], eta, R=R)
    n = _tile(v3((0, 0, 1)), R)
    wi = _tile(v3((0, 0, 1)), R)
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    samp = brdf.sample_brdf(mat, n, wi, st)
    f0 = ((eta - 1) / (eta + 1)) ** 2
    assert np.asarray(samp.is_pure_specular).mean() == pytest.approx(
        f0, abs=3e-3)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

def test_camera_center_ray_points_at_lookat():
    cam = Camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 45.0)
    cd = jnp.asarray(camera_ray_data(cam, 640, 480))
    org, d = generate_primary_rays(cd, jnp.array([0.5]), jnp.array([0.5]))
    np.testing.assert_allclose(vnp(d)[0], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(vnp(org)[0], [0, 0, 0], atol=1e-6)


def test_camera_fov_edges():
    cam = Camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0)
    cd = jnp.asarray(camera_ray_data(cam, 100, 100))
    org, d = generate_primary_rays(cd, jnp.array([0.5]), jnp.array([0.0]))
    dv = vnp(d)[0]
    assert dv[1] / -dv[2] == pytest.approx(1.0, abs=1e-5)
    assert dv[1] > 0  # v measured downward: top row has +y


def test_camera_epsilon_compare():
    a = Camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 45.0)
    b = Camera((0, 0, 1e-7), (0, 0, -1), (0, 1, 0), 45.0)
    c = Camera((0, 0, 0.1), (0, 0, -1), (0, 1, 0), 45.0)
    assert a.almost_equal(b)
    assert not a.almost_equal(c)
