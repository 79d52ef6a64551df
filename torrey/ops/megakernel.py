"""Pallas megakernel for the GPU: the whole progressive sample pass in one
kernel, compiled through Triton.

This is the small-scene path (the reference's interactive corpus: sphere
scenes and the Cornell box).  The XLA integrator (ops/integrator.py) runs
each bounce as one ``lax.while_loop`` iteration over the whole image, so the
ray state goes through device memory on every bounce and the loop predicate
goes back to the host.  Here each program of a 1-D grid owns ``BLOCK``
pixels and keeps their paths in registers from the camera ray to the
accumulated sum, as the reference's per-pixel CUDA kernel does
(radiance.cuh:21-79, launched from main.cu:30-89).  A lane whose path ends
starts its next pass at once, so short paths do not wait for long ones.

The scene is the per-primitive table of models/device_scene.py
(``prim_rows``, at most 512 x 32 f32): the closest-hit loop reads each
primitive with uniform scalar loads that L1 serves to the whole block, and
the winner's attributes are gathered by primitive id afterwards.  Shading
re-derives the hit exactly as ops/shade.py does, with the same RNG streams
(ops/rng.py) in the same draw order (2 camera jitter + 3 BSDF + 1 RR per
bounce), so the kernel agrees with the XLA oracle up to floating-point
contraction; tests/test_megakernel.py states the tolerances.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import brdf, geometry as g, rng
from .integrator import MAX_DEPTH, RR_START_DEPTH, SECONDARY_TNEAR
from .vec import Vec3, cross, dot, max_elem, normalize, where

# Rays per program and warps per program: 64 rays on 2 warps measured
# fastest of 64/2, 128/2, 128/4, 256/4 and 256/8 on cbox at 640x480 (H100;
# PERF.md).  640x480 gives 4,800 programs for the 132 SMs.
BLOCK = 64
NUM_WARPS = 2
INF = float("inf")

# Scenes up to this many primitives render through the megakernel (the
# closest-hit loop is O(P); beyond this the BVH path wins).
MEGAKERNEL_MAX_PRIMS = 512


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _col(rows_ref, k, j):
    """Column ``j`` of primitive ``k`` (a scalar or a per-lane gather)."""
    return rows_ref[k, j]


def _vec(rows_ref, k, j) -> Vec3:
    return Vec3(rows_ref[k, j], rows_ref[k, j + 1], rows_ref[k, j + 2])


def _closest_hit(rows_ref, S: int, F: int, org: Vec3, dirn: Vec3, tnear):
    """(t, prim) of the nearest hit, prim -1 on a miss.  Sequential
    strict-less minimum, so ties go to the lower id as in
    ops/bruteforce.py."""
    best = (jnp.full(org.x.shape, INF, jnp.float32),
            jnp.full(org.x.shape, -1, jnp.int32))

    def sphere(k, best):
        bt, bk = best
        t, hit = g.intersect_sphere(_vec(rows_ref, k, 1),
                                    _col(rows_ref, k, 4), org, dirn,
                                    tnear, bt)
        closer = hit & (t < bt)
        return jnp.where(closer, t, bt), jnp.where(closer, k, bk)

    def triangle(k, best):
        bt, bk = best
        t, _, _, hit = g.intersect_triangle(
            _vec(rows_ref, k, 1), _vec(rows_ref, k, 4), _vec(rows_ref, k, 7),
            org, dirn, tnear, bt)
        closer = hit & (t < bt)
        return jnp.where(closer, t, bt), jnp.where(closer, k, bk)

    if S > 0:
        best = lax.fori_loop(0, S, sphere, best)
    if F > 0:
        best = lax.fori_loop(S, S + F, triangle, best)
    return best


def _occluded(rows_ref, S: int, F: int, org: Vec3, dirn: Vec3, tnear,
              tfar):
    """Any-hit over the primitive table: True where (tnear, tfar) is
    blocked — the shadow ray of point-light NEE."""
    occ = jnp.zeros(org.x.shape, jnp.bool_)

    def sphere(k, occ):
        _, hit = g.intersect_sphere(_vec(rows_ref, k, 1),
                                    _col(rows_ref, k, 4), org, dirn,
                                    tnear, tfar)
        return occ | hit

    def triangle(k, occ):
        _, _, _, hit = g.intersect_triangle(
            _vec(rows_ref, k, 1), _vec(rows_ref, k, 4), _vec(rows_ref, k, 7),
            org, dirn, tnear, tfar)
        return occ | hit

    if S > 0:
        occ = lax.fori_loop(0, S, sphere, occ)
    if F > 0:
        occ = lax.fori_loop(S, S + F, triangle, occ)
    return occ


def _shade(rows_ref, S: int, F: int, prim, org: Vec3, dirn: Vec3, tnear):
    """Hit record of ``prim`` (>= 0): position, shading normal, material
    and emission — the same re-intersection as ops/shade.py::shade_setup,
    on attributes gathered from the primitive table."""
    is_sph = prim < S
    pos = ns = None
    if S > 0:
        c = _vec(rows_ref, prim, 1)
        t_s, _ = g.intersect_sphere(c, _col(rows_ref, prim, 4), org, dirn,
                                    tnear, INF)
        pos = org + dirn * t_s
        ns = normalize(pos - c)
    if F > 0:
        p0 = _vec(rows_ref, prim, 1)
        e1 = _vec(rows_ref, prim, 4)
        e2 = _vec(rows_ref, prim, 7)
        _, u, v, _ = g.intersect_triangle(p0, e1, e2, org, dirn, -INF, INF)
        w = 1.0 - u - v
        pos_t = p0 + e1 * u + e2 * v
        n_interp = normalize(_vec(rows_ref, prim, 10) * w
                             + _vec(rows_ref, prim, 13) * u
                             + _vec(rows_ref, prim, 16) * v)
        smooth = _col(rows_ref, prim, 28) > 0.5
        ns_t = where(smooth, n_interp, normalize(cross(e1, e2)))
        pos = pos_t if pos is None else where(is_sph, pos, pos_t)
        ns = ns_t if ns is None else where(is_sph, ns, ns_t)
    mat = brdf.MatLookup(mtype=_col(rows_ref, prim, 19).astype(jnp.int32),
                         color=_vec(rows_ref, prim, 20),
                         param=_col(rows_ref, prim, 23))
    emitter = _col(rows_ref, prim, 27) > 0.5
    return pos, ns, mat, _vec(rows_ref, prim, 24), emitter


def _make_kernel(width: int, height: int, S: int, F: int, seed: int,
                 max_depth: int, rr_start_depth: int, num_lights: int,
                 block: int):
    """Kernel body for one program: ``block`` pixels, ``num_passes`` paths
    each (a runtime input).  A lane starts its next path the moment its
    current one ends (path regeneration), so no lane idles while the rest
    of its block finishes; this measured faster than tracing one pass of
    the whole block at a time (PERF.md)."""
    R = width * height

    def kernel(params_ref, meta_ref, rows_ref, *rest):
        if num_lights:
            lights_ref, out_r, out_g, out_b = rest
        else:
            out_r, out_g, out_b = rest
        # meta: sample_start, first block of this shard (tile sharding
        # renders a range of blocks per device, parallel/sharding.py), and
        # the number of passes to render
        sample_start = meta_ref[0]
        pix = (pl.program_id(0) + meta_ref[1]) * block + lax.iota(
            jnp.int32, block)
        num_passes = meta_ref[2]
        valid = pix < R
        fi = lax.rem(pix, width).astype(jnp.float32)
        fj = lax.div(pix, width).astype(jnp.float32)
        pix_u = pix.astype(jnp.uint32)

        cam_o = Vec3(params_ref[0], params_ref[1], params_ref[2])
        cam_tl = Vec3(params_ref[3], params_ref[4], params_ref[5])
        cam_h = Vec3(params_ref[6], params_ref[7], params_ref[8])
        cam_v = Vec3(params_ref[9], params_ref[10], params_ref[11])
        bg = Vec3(params_ref[12], params_ref[13], params_ref[14])
        zeros = jnp.zeros((block,), jnp.float32)
        zero3 = Vec3(zeros, zeros, zeros)

        def camera_ray(sample):
            """(state, org, dirn) of each lane's pass ``sample`` —
            ops/integrator.py::render_pixel_sums and ops/camera.py."""
            state = rng.seed_rays(pix_u, (sample_start + sample).astype(
                jnp.uint32), seed)
            state, u1 = rng.next_uniform(state)
            state, u2 = rng.next_uniform(state)
            u = (fi + u1) / width
            v = (fj + u2) / height
            dirn = normalize(Vec3(
                cam_tl.x + u * cam_h.x - v * cam_v.x - cam_o.x,
                cam_tl.y + u * cam_h.y - v * cam_v.y - cam_o.y,
                cam_tl.z + u * cam_h.z - v * cam_v.z - cam_o.z))
            org = Vec3(zeros + cam_o.x, zeros + cam_o.y, zeros + cam_o.z)
            return state, org, dirn

        def direct_light(pos, n, wi, mat, T, active):
            # ops/integrator.py::_direct_point_lights semantics
            out = zero3
            for l in range(num_lights):
                d = _vec(lights_ref, l, 0) - pos
                dist2 = dot(d, d)
                dist = jnp.sqrt(dist2)
                wo = d * (1.0 / jnp.maximum(dist, 1e-20))
                ev = brdf.eval_brdf(mat, n, wi, wo)
                occ = _occluded(rows_ref, S, F, pos, wo, SECONDARY_TNEAR,
                                dist * (1.0 - 1e-3))
                contrib = T * ev.value * _vec(lights_ref, l, 3) * (
                    1.0 / jnp.maximum(dist2, 1e-20))
                out = out + where(active & ~occ, contrib, zero3)
            return out

        def bounce(depth, tnear, org, dirn, T, L, active, state):
            # ops/integrator.py::_bounce, step for step
            _, prim = _closest_hit(rows_ref, S, F, org, dirn, tnear)
            miss = prim < 0
            L = where(active & miss, L + T * bg, L)
            active = active & ~miss

            pos, ns, mat, em, emitter = _shade(
                rows_ref, S, F, jnp.maximum(prim, 0), org, dirn, tnear)
            wi = -dirn
            cos_view = dot(wi, ns)
            L = where(active & emitter & (cos_view > 0.0), L + T * em, L)
            n = where(cos_view < 0.0, -ns, ns)
            if num_lights:
                L = L + direct_light(pos, n, wi, mat, T, active)

            state, u1 = rng.next_uniform(state)
            state, u2 = rng.next_uniform(state)
            state, u3 = rng.next_uniform(state)
            wo, is_spec, weight = brdf.sample_brdf_from_uniforms(
                mat, n, wi, u1, u2, u3)
            ev = brdf.eval_brdf(mat, n, wi, wo)
            ok_spec = max_elem(weight) > 0.0
            ok_scatter = (max_elem(ev.value) > 0.0) & (ev.pdf > 0.0)
            pdf_safe = jnp.where(ev.pdf > 0.0, ev.pdf, 1.0)
            contrib = where(is_spec, weight, ev.value * (1.0 / pdf_safe))
            ok = jnp.where(is_spec, ok_spec, ok_scatter)
            T = where(active & ok, T * contrib, T)
            active = active & ok
            org = where(active, pos, org)
            dirn = where(active, wo, dirn)

            state, u = rng.next_uniform(state)
            rr_on = depth > rr_start_depth
            p = jnp.maximum(0.5, 1.0 - max_elem(T))
            kill = rr_on & (u < p)
            scale = 1.0 / jnp.where(rr_on & ~kill & (p < 1.0), 1.0 - p, 1.0)
            T = where(active & rr_on & ~kill, T * scale, T)
            active = active & ~kill
            return org, dirn, T, L, active, state

        def body(st):
            s, depth, org, dirn, T, L, active, state, acc = st
            regen = ~active & (s < num_passes)
            r_state, r_org, r_dirn = camera_ray(s)
            org = where(regen, r_org, org)
            dirn = where(regen, r_dirn, dirn)
            T = where(regen, Vec3(zeros + 1.0, zeros + 1.0, zeros + 1.0), T)
            L = where(regen, zero3, L)
            state = jnp.where(regen, r_state, state)
            depth = jnp.where(regen, 0, depth)
            s = jnp.where(regen, s + 1, s)
            was_active = active | regen
            tnear = jnp.where(depth > 0, SECONDARY_TNEAR, 0.0)
            org, dirn, T, L, active, state = bounce(
                depth, tnear, org, dirn, T, L, was_active, state)
            depth = depth + 1
            active = active & (depth < max_depth)   # radiance.cuh:24 bound
            acc = where(was_active & ~active, acc + L, acc)
            return s, depth, org, dirn, T, L, active, state, acc

        # padding lanes (pix >= W*H) start with every pass taken
        zi = jnp.zeros((block,), jnp.int32)
        st = (jnp.where(valid, 0, num_passes), zi, zero3, zero3, zero3,
              zero3, jnp.zeros((block,), jnp.bool_), zi.astype(jnp.uint32),
              zero3)
        acc = lax.while_loop(
            lambda st: jnp.max((st[6] | (st[0] < num_passes)).astype(
                jnp.int32)) > 0, body, st)[8]
        out_r[...] = acc.x
        out_g[...] = acc.y
        out_b[...] = acc.z

    return kernel


def total_blocks(width: int, height: int) -> int:
    return -(-(width * height) // BLOCK)


def pack_params(cam_data, bg) -> jnp.ndarray:
    """[16] f32: camera (origin, top-left, horizontal, vertical), then the
    background radiance."""
    return jnp.zeros((16,), jnp.float32).at[:12].set(
        cam_data.reshape(12).astype(jnp.float32)).at[12:15].set(bg)


def render_blocks(prim_rows, params, sample_start, blk0, num_passes,
                  width: int, height: int, n_blocks: int, seed: int,
                  max_depth: int, S: int, F: int, interpret: bool = False,
                  rr_start_depth: int = RR_START_DEPTH, light_rows=None):
    """Render blocks [blk0, blk0 + n_blocks) of the flat pixel space — the
    unit multi-device sharding partitions.  Returns (r, g, b), each
    [n_blocks * BLOCK]: the radiance sums of passes sample_start ..
    sample_start + num_passes - 1 (``num_passes`` may be traced)."""
    meta = jnp.stack([jnp.asarray(sample_start, jnp.int32),
                      jnp.asarray(blk0, jnp.int32),
                      jnp.asarray(num_passes, jnp.int32), jnp.int32(0)])
    # Triton wants power-of-two shapes; padding rows are never read
    pad = lambda a: jnp.pad(a, ((0, _next_pow2(a.shape[0]) - a.shape[0]),
                                (0, 0)))
    args = [params, meta, pad(prim_rows)]
    NL = 0 if light_rows is None else int(light_rows.shape[0])
    if NL:
        args.append(pad(light_rows))
    kernel = _make_kernel(width, height, S, F, seed, max_depth,
                          rr_start_depth, NL, BLOCK)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    out = jax.ShapeDtypeStruct((n_blocks * BLOCK,), jnp.float32)
    outspec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[whole(a) for a in args],
        out_specs=(outspec,) * 3,
        out_shape=(out,) * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="megakernel",
    )(*args)


def pack_light_rows(scene):
    """[NL, 8] f32 point-light table (pos xyz, intensity rgb, pad), or None
    when the scene has no point lights."""
    NL = int(scene.light_pos.shape[0])
    if NL == 0:
        return None
    rows = jnp.zeros((NL, 8), jnp.float32)
    rows = rows.at[:, 0:3].set(jnp.asarray(scene.light_pos, jnp.float32))
    return rows.at[:, 3:6].set(jnp.asarray(scene.light_intensity,
                                           jnp.float32))


def scene_background(scene):
    return jnp.stack([jnp.asarray(scene.bg_r), jnp.asarray(scene.bg_g),
                      jnp.asarray(scene.bg_b)])


@partial(jax.jit, static_argnames=("width", "height", "num_samples", "seed",
                                   "max_depth", "interpret", "rr_start_depth",
                                   "nee"))
def render_samples_pallas(scene, cam_data, width: int, height: int,
                          sample_start, num_samples: int = 1,
                          seed: int = 1984, max_depth: int = MAX_DEPTH,
                          interpret: bool = False,
                          rr_start_depth: int = RR_START_DEPTH,
                          nee: bool = False):
    """Drop-in replacement for ops.integrator.render_samples on scenes with
    <= MEGAKERNEL_MAX_PRIMS primitives: the [H, W, 3] radiance sum of
    ``num_samples`` passes.  ``nee=True`` adds point-light next-event
    estimation."""
    params = pack_params(cam_data, scene_background(scene))
    light_rows = pack_light_rows(scene) if nee else None
    r, g_, b = render_blocks(scene.prim_rows, params, sample_start, 0,
                             num_samples, width, height,
                             total_blocks(width, height), seed, max_depth,
                             scene.num_spheres, scene.num_triangles,
                             interpret, rr_start_depth, light_rows)
    R = width * height
    return jnp.stack([r[:R], g_[:R], b[:R]], axis=-1).reshape(height, width,
                                                              3)
