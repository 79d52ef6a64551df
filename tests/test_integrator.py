"""Integrator correctness: furnace tests, analytic scenes, BVH-vs-brute
equivalence, progressive accumulation semantics (SURVEY.md §4b/§4d)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torrey.models.device_scene import DeviceScene
from torrey.models.ir import (ParsedCamera,
                                                       ParsedDiffuse,
                                                       ParsedDiffuseAreaLight,
                                                       ParsedMirror,
                                                       ParsedScene,
                                                       ParsedSphere)
from torrey.models.scenepack import pack_scene
from torrey.ops import rng
from torrey.ops.bruteforce import intersect_brute
from torrey.ops.integrator import (radiance,
                                                            radiance_fixed,
                                                            render_samples)
from torrey.ops.trace import trace_rays
from torrey.ops.vec import Vec3


def _cam(w=8, h=8):
    return ParsedCamera(np.zeros(3, np.float32),
                        np.array([0, 0, -1], np.float32),
                        np.array([0, 1, 0], np.float32), 45.0, w, h)


def _sphere(center, radius, material_id, area_light_id=-1):
    return ParsedSphere(material_id, area_light_id,
                        np.asarray(center, np.float32), radius)


def make_scene(shapes, materials, lights=(), background=(0.5, 0.5, 0.5)):
    pack = pack_scene(ParsedScene(_cam(), list(materials), list(lights),
                                  list(shapes),
                                  np.asarray(background, np.float32), 16))
    return DeviceScene.from_pack(pack)


def _rays(dirs):
    d = np.asarray(dirs, np.float32)
    R = d.shape[0]
    org = Vec3.zeros((R,))
    dirn = Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]),
                jnp.asarray(d[:, 2]))
    return org, dirn


def _L(vec):
    return np.stack([np.asarray(vec.x), np.asarray(vec.y),
                     np.asarray(vec.z)], -1)


def test_all_miss_gives_background():
    scene = make_scene([_sphere([0, 0, 10], 1.0, 0)],
                       [ParsedDiffuse(np.array([0.5] * 3, np.float32))],
                       background=(0.25, 0.5, 0.75))
    R = 64
    org, d = _rays(np.tile([0.0, 0.0, -1.0], (R, 1)))
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    L = _L(radiance(scene, org, d, st))
    np.testing.assert_allclose(L, np.tile([0.25, 0.5, 0.75], (R, 1)),
                               atol=1e-6)


def test_white_furnace():
    """White diffuse sphere in unit-white background: every path escapes
    with throughput 1 (value/pdf == reflectance == 1), so E[L] == 1."""
    scene = make_scene([_sphere([0, 0, -3], 1.0, 0)],
                       [ParsedDiffuse(np.array([1.0] * 3, np.float32))],
                       background=(1, 1, 1))
    R = 512
    org, d = _rays(np.tile([0.0, 0.0, -1.0], (R, 1)))
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    L = _L(radiance(scene, org, d, st))
    assert abs(L.mean() - 1.0) < 0.02
    assert np.all(np.isfinite(L))


def test_emitter_direct_hit_front_only():
    light = ParsedDiffuseAreaLight(0, np.array([2.0, 3.0, 4.0], np.float32))
    scene = make_scene(
        [_sphere([0, 0, -3], 1.0, 0, area_light_id=0)],
        [ParsedDiffuse(np.array([0.0] * 3, np.float32))],
        lights=[light], background=(0, 0, 0))
    R = 4
    org, d = _rays(np.tile([0.0, 0.0, -1.0], (R, 1)))
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    L = _L(radiance(scene, org, d, st))
    np.testing.assert_allclose(L, np.tile([2, 3, 4], (R, 1)), atol=1e-5)


def test_mirror_reflects_background():
    scene = make_scene([_sphere([0, 0, -3], 1.0, 0)],
                       [ParsedMirror(np.array([1.0] * 3, np.float32))],
                       background=(0.2, 0.4, 0.8))
    R = 16
    org, d = _rays(np.tile([0.0, 0.0, -1.0], (R, 1)))
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    L = _L(radiance(scene, org, d, st))
    np.testing.assert_allclose(L, np.tile([0.2, 0.4, 0.8], (R, 1)), atol=1e-5)


def test_radiance_fixed_matches_radiance():
    """while-loop and scan variants share _bounce and RNG streams, so they
    must agree exactly at equal depth."""
    scene = make_scene(
        [_sphere([0, 0, -3], 1.0, 0), _sphere([0, -101.5, -3], 100.0, 1)],
        [ParsedDiffuse(np.array([0.8, 0.6, 0.4], np.float32)),
         ParsedDiffuse(np.array([0.3, 0.5, 0.7], np.float32))])
    R = 256
    rv = np.random.default_rng(0)
    d = rv.normal(size=(R, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org, dj = _rays(d)
    st = rng.seed_rays(jnp.arange(R, dtype=jnp.uint32), 0)
    L1 = _L(radiance(scene, org, dj, st, max_depth=12))
    L2 = _L(radiance_fixed(scene, org, dj, st, num_bounces=12, use_rr=True))
    np.testing.assert_allclose(L1, L2, atol=1e-5)


def test_bvh_equals_bruteforce_random_scene():
    """BVH traversal and brute-force must find the same closest hit
    (aabb_test-style stress, SURVEY.md §4)."""
    rv = np.random.default_rng(3)
    shapes = [_sphere(rv.uniform(-3, 3, 3), rv.uniform(0.2, 0.6), 0)
              for _ in range(30)]
    scene = make_scene(shapes,
                       [ParsedDiffuse(np.array([0.5] * 3, np.float32))])
    R = 2048
    o = rv.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = rv.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dirn = Vec3(jnp.asarray(d[:, 0].astype(np.float32)),
                jnp.asarray(d[:, 1].astype(np.float32)),
                jnp.asarray(d[:, 2].astype(np.float32)))
    p1, t1 = trace_rays(scene.bvh_nodes, org, dirn, jnp.float32(0.0))
    p2, t2 = intersect_brute(scene, org, dirn, jnp.float32(0.0))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    hit = np.asarray(p1) >= 0
    # loose rtol: the two programs fuse/reassociate fp32 FMAs differently
    np.testing.assert_allclose(np.asarray(t1)[hit], np.asarray(t2)[hit],
                               rtol=1e-3)


def test_render_samples_deterministic_and_progressive():
    scene = make_scene([_sphere([0, 0, -3], 1.0, 0)],
                       [ParsedDiffuse(np.array([0.6] * 3, np.float32))])
    cd = jnp.asarray(
        np.array([[0, 0, 0], [-0.5, 0.375, -1], [1, 0, 0], [0, 0.75, 0]],
                 np.float32))
    a = np.asarray(render_samples(scene, cd, 16, 12, jnp.uint32(0),
                                  num_samples=2))
    b = np.asarray(render_samples(scene, cd, 16, 12, jnp.uint32(0),
                                  num_samples=2))
    np.testing.assert_array_equal(a, b)  # fixed seed reproducibility
    c = np.asarray(render_samples(scene, cd, 16, 12, jnp.uint32(2),
                                  num_samples=2))
    assert not np.array_equal(a, c)  # fresh samples differ
    assert a.shape == (12, 16, 3)


def test_image_statistics_converge():
    scene = make_scene(
        [_sphere([0, 0, -3], 1.0, 0), _sphere([0, -101.5, -3], 100.0, 0)],
        [ParsedDiffuse(np.array([0.7] * 3, np.float32))])
    cd = jnp.asarray(
        np.array([[0, 0, 0], [-0.5, 0.375, -1], [1, 0, 0], [0, 0.75, 0]],
                 np.float32))
    r1 = np.asarray(render_samples(scene, cd, 32, 24, jnp.uint32(0),
                                   num_samples=4)) / 4
    r2 = np.asarray(render_samples(scene, cd, 32, 24, jnp.uint32(100),
                                   num_samples=4)) / 4
    r3 = np.asarray(render_samples(scene, cd, 32, 24, jnp.uint32(200),
                                   num_samples=32)) / 32
    r4 = np.asarray(render_samples(scene, cd, 32, 24, jnp.uint32(400),
                                   num_samples=32)) / 32
    assert np.abs(r3 - r4).mean() < np.abs(r1 - r2).mean()
