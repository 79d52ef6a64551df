"""Brute-force broadcast intersector for small scenes (SoA layout).

For scenes with up to a few hundred primitives (the reference's
interactive corpus: 4-40 spheres, the 36-triangle Cornell box) the
simplest XLA "traversal" is none: test every primitive against every ray
in statically-unrolled chunks, with zero gathers and zero data-dependent
loops.  The chunk axis is the *leading* dimension ([C, rows, 128]).

The BVH path (ops/trace.py) takes over for large meshes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.device_scene import DeviceScene
from . import geometry as g
from .vec import Vec3

CHUNK = 8
# Scenes with at most this many primitives use brute force (static choice).
BRUTE_FORCE_MAX_PRIMS = 512


def _expand(ray_v: Vec3) -> Vec3:
    """ray components -> leading singleton chunk axis for broadcasting."""
    return Vec3(ray_v.x[None], ray_v.y[None], ray_v.z[None])


def _chunk(arr, c0, c1, ray_ndim):
    """[C] slice -> [C, 1...] with ray_ndim trailing singletons."""
    return arr[c0:c1].reshape((c1 - c0,) + (1,) * ray_ndim)


def _chunk_vec(xs, ys, zs, c0, c1, ray_ndim) -> Vec3:
    return Vec3(_chunk(xs, c0, c1, ray_ndim), _chunk(ys, c0, c1, ray_ndim),
                _chunk(zs, c0, c1, ray_ndim))


def intersect_brute(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear):
    """Closest-hit over all primitives.  org/dirn: Vec3 of [rows,128].
    Returns (prim [rows,128] i32, -1 = miss; t [rows,128])."""
    shape = org.x.shape
    best_t = jnp.full(shape, jnp.inf, jnp.float32)
    best_prim = jnp.full(shape, -1, jnp.int32)
    org_e = _expand(org)
    dirn_e = _expand(dirn)
    tnear_e = jnp.asarray(tnear, jnp.float32)[None] if jnp.ndim(tnear) \
        else tnear

    S = scene.num_spheres
    F = scene.num_triangles

    nd = org.x.ndim
    for c0 in range(0, S, CHUNK):
        c1 = min(c0 + CHUNK, S)
        center = _chunk_vec(scene.sph_x, scene.sph_y, scene.sph_z, c0, c1, nd)
        radius = _chunk(scene.sph_rad, c0, c1, nd)
        t, hit = g.intersect_sphere(center, radius, org_e, dirn_e,
                                    tnear_e, best_t[None])
        t = jnp.where(hit, t, jnp.inf)                    # [C,rows,128]
        k = jnp.argmin(t, axis=0)
        tk = jnp.min(t, axis=0)
        closer = tk < best_t
        best_t = jnp.where(closer, tk, best_t)
        best_prim = jnp.where(closer, (c0 + k).astype(jnp.int32), best_prim)

    for c0 in range(0, F, CHUNK):
        c1 = min(c0 + CHUNK, F)
        p0 = _chunk_vec(scene.tri_p0x, scene.tri_p0y, scene.tri_p0z, c0, c1, nd)
        e1 = _chunk_vec(scene.tri_e1x, scene.tri_e1y, scene.tri_e1z, c0, c1, nd)
        e2 = _chunk_vec(scene.tri_e2x, scene.tri_e2y, scene.tri_e2z, c0, c1, nd)
        t, _u, _v, hit = g.intersect_triangle(p0, e1, e2, org_e, dirn_e,
                                              tnear_e, best_t[None])
        t = jnp.where(hit, t, jnp.inf)
        k = jnp.argmin(t, axis=0)
        tk = jnp.min(t, axis=0)
        closer = tk < best_t
        best_t = jnp.where(closer, tk, best_t)
        best_prim = jnp.where(closer, (S + c0 + k).astype(jnp.int32),
                              best_prim)

    return best_prim, best_t
