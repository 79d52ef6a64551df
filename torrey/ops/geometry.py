"""Device-side geometry math (JAX, SoA over ray batches).

Equivalents of the reference's device functions: sphere and
triangle intersection (shape.cuh:110-215), AABB slab test (bbox.cuh:35-61),
orthonormal frames (frame.h:17-64) and hemisphere sampling
(scene.h:338-357).  All vectors are :class:`~..ops.vec.Vec3` — three
separate component arrays.  Branches become ``jnp.where`` masks; there is
no data-dependent control flow anywhere, so the same functions run in the
XLA integrator and inside the megakernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .vec import Vec3, cross, dot, normalize, reflect, where  # noqa: F401

# NOTE: Python floats, never jnp arrays — a module-level jnp scalar is a
# committed device buffer and costs a host sync when folded into jit.
INF = float("inf")
TWO_PI = float(2.0 * jnp.pi)
PI = float(jnp.pi)


# ---------------------------------------------------------------------------
# AABB slab test (bbox.cuh:35-61 semantics; per-axis swap becomes min/max)
# ---------------------------------------------------------------------------

def slab_test(org: Vec3, inv_dir: Vec3, box_min: Vec3, box_max: Vec3, t_max):
    """Hit mask: tfar >= max(0, tnear) (reference Hit()) plus
    tnear <= t_max closest-hit pruning (identical results)."""
    tx0 = (box_min.x - org.x) * inv_dir.x
    tx1 = (box_max.x - org.x) * inv_dir.x
    ty0 = (box_min.y - org.y) * inv_dir.y
    ty1 = (box_max.y - org.y) * inv_dir.y
    tz0 = (box_min.z - org.z) * inv_dir.z
    tz1 = (box_max.z - org.z) * inv_dir.z
    tn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                     jnp.minimum(tz0, tz1))
    tf = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                     jnp.maximum(tz0, tz1))
    return (tf >= jnp.maximum(tn, 0.0)) & (tn <= t_max)


# ---------------------------------------------------------------------------
# Sphere intersection (shape.cuh:110-186 semantics)
# ---------------------------------------------------------------------------

def intersect_sphere(center: Vec3, radius, org: Vec3, dirn: Vec3, tnear, tfar):
    """Numerically-stable quadratic + root selection matching
    find_intersection_with_sphere.  Returns (t, hit_mask)."""
    v = org - center
    a = dot(dirn, dirn)
    b = 2.0 * dot(dirn, v)
    c = dot(v, v) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    root_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b >= 0.0, -b - root_disc, -b + root_disc)
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    r0 = jnp.where(b >= 0.0, q / (2.0 * safe_a), 2.0 * c / safe_q)
    r1 = jnp.where(b >= 0.0, 2.0 * c / safe_q, q / (2.0 * safe_a))
    lin_ok = b != 0.0
    lin_t = -c / jnp.where(lin_ok, b, 1.0)
    t0 = jnp.where(a == 0.0, lin_t, jnp.minimum(r0, r1))
    t1 = jnp.where(a == 0.0, lin_t, jnp.maximum(r0, r1))
    has_root = jnp.where(a == 0.0, lin_ok, has_root)

    t0_ok = (t0 >= tnear) & (t0 < tfar)
    t1_ok = (t1 >= tnear) & (t1 < tfar)
    t = jnp.where(t0_ok, t0, jnp.where(t1_ok, t1, t0))
    hit = has_root & (t >= tnear) & (t < tfar)
    return t, hit


def sphere_shading(center: Vec3, radius, org: Vec3, dirn: Vec3, t):
    """Position / normal / spherical uv at parameter t (shape.cuh:163-179).
    Returns (p: Vec3, n: Vec3, u, v)."""
    p = org + dirn * t
    n = normalize(p - center)
    theta = jnp.arccos(jnp.clip(n.y, -1.0, 1.0))
    phi = jnp.arctan2(-n.z, n.x) + PI
    return p, n, phi / TWO_PI, theta / PI


# ---------------------------------------------------------------------------
# Triangle intersection (shape.cuh:188-215, precomputed edges)
# ---------------------------------------------------------------------------

def intersect_triangle(p0: Vec3, e1: Vec3, e2: Vec3, org: Vec3, dirn: Vec3,
                       tnear, tfar):
    """Moller-Trumbore with e1 = p1-p0, e2 = p2-p0.
    Returns (t, u, v, hit_mask)."""
    s1 = cross(dirn, e2)
    divisor = dot(s1, e1)
    ok = divisor != 0.0
    inv_div = 1.0 / jnp.where(ok, divisor, 1.0)
    s = org - p0
    u = dot(s, s1) * inv_div
    s2 = cross(s, e1)
    v = dot(dirn, s2) * inv_div
    t = dot(e2, s2) * inv_div
    hit = ok & (t > tnear) & (t < tfar) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


# ---------------------------------------------------------------------------
# Orthonormal frames.  Reference: Frisvad with a -z special case
# (frame.h:17-64); we use the branchless stable revision (Duff et al. 2017).
# ---------------------------------------------------------------------------

def make_frame(n: Vec3):
    """Returns (x, y) tangents completing unit n to an ONB."""
    s = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    x = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    y = Vec3(b, s + n.y * n.y * a, -n.y)
    return x, y


def frame_to_world(x: Vec3, y: Vec3, n: Vec3, v: Vec3) -> Vec3:
    return x * v.x + y * v.y + n * v.z


# ---------------------------------------------------------------------------
# Hemisphere sampling (scene.h:338-357)
# ---------------------------------------------------------------------------

def sample_cos_hemisphere(u1, u2) -> Vec3:
    phi = TWO_PI * u1
    tmp = jnp.sqrt(jnp.clip(1.0 - u2, 0.0, 1.0))
    return Vec3(jnp.cos(phi) * tmp, jnp.sin(phi) * tmp,
                jnp.sqrt(jnp.clip(u2, 0.0, 1.0)))


def sample_cos_n_hemisphere(u1, u2, exponent) -> Vec3:
    phi = TWO_PI * u1
    cos_theta = jnp.clip(u2, 1e-30, 1.0) ** (1.0 / (exponent + 1.0))
    sin_theta = jnp.sqrt(jnp.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    return Vec3(jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta)


def schlick_fresnel(f0: Vec3, cos_theta) -> Vec3:
    """F0 + (1-F0)(1-cos)^5 (scene.h:333-336)."""
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    m5 = m * m * m * m * m
    return Vec3(f0.x + (1.0 - f0.x) * m5,
                f0.y + (1.0 - f0.y) * m5,
                f0.z + (1.0 - f0.z) * m5)
