"""BRDF sampling and evaluation (diffuse / mirror / plastic / Phong), SoA.

Equivalent of the reference's tagged-union dispatch
(eval_brdf scene.h:364-412, sample_brdf scene.h:422-464).  The CUDA code
branches per thread on ``mat.type``; here all four lobes are evaluated
branchlessly over the whole lane batch and selected with masks — only four
cheap lobes, so this wastes little and keeps the schedule static.

Conventions exactly match the reference:
  * ``wi`` points toward the viewer (= -ray.dir); ``n`` is the shading
    normal already flipped toward the ray (radiance.cuh:45-47).
  * mirror and the plastic specular lobe are "pure specular": sampler
    returns a weight, eval returns 0 (scene.h:377-379, 434-447).
  * plastic F0 = ((eta-1)/(eta+1))^2, lobe-selected with prob F
    (scene.h:439-453).
  * Phong samples cos^n around the reflection of ``wi`` (scene.h:455-460).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..models.device_scene import DeviceScene
from ..models.scenepack import (MAT_DIFFUSE, MAT_MIRROR, MAT_PHONG,
                                MAT_PLASTIC)
from . import geometry as g
from . import rng
from .vec import Vec3, dot, reflect, where

_INV_PI = float(1.0 / jnp.pi)  # python float: jnp module consts poison jit


class MatLookup(NamedTuple):
    mtype: jnp.ndarray   # [rows,128] i32
    color: Vec3          # reflectance
    param: jnp.ndarray   # eta or exponent


def lookup_materials(scene: DeviceScene, material_id) -> MatLookup:
    mid = jnp.clip(material_id, 0, scene.mat_type.shape[0] - 1)
    take = lambda a: jnp.take(a, mid, axis=0)
    return MatLookup(
        mtype=take(scene.mat_type),
        color=Vec3(take(scene.mat_r), take(scene.mat_g), take(scene.mat_b)),
        param=take(scene.mat_param),
    )


class SampleRecord(NamedTuple):
    wo: Vec3
    is_pure_specular: jnp.ndarray
    weight: Vec3          # valid when pure specular
    state: jnp.ndarray    # advanced RNG state


def _plastic_f0(eta):
    return ((eta - 1.0) / (eta + 1.0)) ** 2


def sample_brdf(mat: MatLookup, n: Vec3, wi: Vec3,
                state: jnp.ndarray) -> SampleRecord:
    """Reference: sample_brdf (scene.h:422-464).  Consumes a fixed 3 draws
    per lane regardless of material, keeping lanes in lockstep."""
    state, u1, u2 = rng.next_uniform2(state)
    state, u3 = rng.next_uniform(state)
    wo, is_spec, weight = sample_brdf_from_uniforms(mat, n, wi, u1, u2, u3)
    return SampleRecord(wo, is_spec, weight, state)


def sample_brdf_from_uniforms(mat: MatLookup, n: Vec3, wi: Vec3, u1, u2, u3):
    """Core lobe selection on pre-drawn uniforms; shared by the XLA path
    above and the megakernel.
    Returns (wo, is_pure_specular, weight)."""
    fx, fy = g.make_frame(n)
    refl = reflect(wi, n)

    wo_diff = g.frame_to_world(fx, fy, n, g.sample_cos_hemisphere(u1, u2))

    f_mirror = g.schlick_fresnel(mat.color, dot(n, refl))

    f0 = _plastic_f0(mat.param)
    f_plastic = g.schlick_fresnel(Vec3(f0, f0, f0), dot(n, wi))
    plastic_spec = u3 <= f_plastic.x

    rx, ry = g.make_frame(refl)
    wo_phong = g.frame_to_world(
        rx, ry, refl, g.sample_cos_n_hemisphere(u1, u2, mat.param))

    t = mat.mtype
    wo = where(t == MAT_MIRROR, refl, wo_diff)
    wo = where((t == MAT_PLASTIC) & plastic_spec, refl, wo)
    wo = where(t == MAT_PHONG, wo_phong, wo)

    is_spec = (t == MAT_MIRROR) | ((t == MAT_PLASTIC) & plastic_spec)
    ones = Vec3(jnp.ones_like(u1), jnp.ones_like(u1), jnp.ones_like(u1))
    weight = where(t == MAT_MIRROR, f_mirror, ones)
    return wo, is_spec, weight


class EvalRecord(NamedTuple):
    value: Vec3
    pdf: jnp.ndarray


def eval_brdf(mat: MatLookup, n: Vec3, wi: Vec3, wo: Vec3) -> EvalRecord:
    """Reference: eval_brdf (scene.h:364-412).  Mirror (and the plastic
    specular lobe) return 0 — handled by the sampler's weight."""
    n_dot_wo = jnp.maximum(dot(wo, n), 0.0)
    cos_term = n_dot_wo * _INV_PI

    # diffuse
    val_diff = mat.color * cos_term
    pdf_diff = cos_term

    # plastic diffuse lobe
    f0 = _plastic_f0(mat.param)
    f = g.schlick_fresnel(Vec3(f0, f0, f0), dot(n, wi))
    val_plastic = (Vec3(1.0 - f.x, 1.0 - f.y, 1.0 - f.z)
                   * mat.color * cos_term)
    pdf_plastic = (1.0 - f.x) * cos_term

    # phong
    refl = reflect(wi, n)
    r_dot_wo = dot(refl, wo)
    lobe_ok = (r_dot_wo > 0.0) & (dot(n, wo) > 0.0)
    norm = (mat.param + 1.0) * float(0.5 / jnp.pi)
    phong_resp = norm * jnp.power(jnp.maximum(r_dot_wo, 1e-30), mat.param)
    phong_resp = jnp.where(lobe_ok, phong_resp, 0.0)
    val_phong = mat.color * phong_resp
    pdf_phong = phong_resp

    t = mat.mtype
    zero = Vec3.zeros(n_dot_wo.shape)
    value = where(t == MAT_DIFFUSE, val_diff, zero)
    value = where(t == MAT_PLASTIC, val_plastic, value)
    value = where(t == MAT_PHONG, val_phong, value)
    pdf = jnp.where(t == MAT_DIFFUSE, pdf_diff, 0.0)
    pdf = jnp.where(t == MAT_PLASTIC, pdf_plastic, pdf)
    pdf = jnp.where(t == MAT_PHONG, pdf_phong, pdf)
    return EvalRecord(value, pdf)
