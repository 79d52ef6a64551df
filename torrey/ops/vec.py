"""SoA 3-vector type for ray batches.

The reference's math layer is Cg-style ``float3`` AoS (cutil_math.h).
``Vec3`` holds three *separate* arrays — each shaped ``[rows, 128]`` for a
ray batch, or ``[BLOCK]`` inside the megakernel — so elementwise math on a
component is contiguous and no op works on a minor dimension of 3.  It is a
NamedTuple, hence automatically a JAX pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- construction ----------------------------------------------------
    @staticmethod
    def from_array(a) -> "Vec3":
        """[..., 3] array -> Vec3 of [...] components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(shape, vals, dtype=jnp.float32) -> "Vec3":
        return Vec3(jnp.full(shape, vals[0], dtype),
                    jnp.full(shape, vals[1], dtype),
                    jnp.full(shape, vals[2], dtype))

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)

    def to_array(self) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic ------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length2(a: Vec3):
    return dot(a, a)


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = jax.lax.rsqrt(jnp.maximum(length2(a), eps))
    return a * inv


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(mask, a.x, b.x),
                jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def max_elem(a: Vec3):
    return jnp.maximum(jnp.maximum(a.x, a.y), a.z)


def min_elem(a: Vec3):
    return jnp.minimum(jnp.minimum(a.x, a.y), a.z)


def reflect(wi: Vec3, n: Vec3) -> Vec3:
    """-wi + 2 dot(wi, n) n (scene.h:435)."""
    return -wi + n * (2.0 * dot(wi, n))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a * (1.0 - t) + b * t
