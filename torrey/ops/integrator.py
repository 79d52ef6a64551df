"""Masked wavefront path-tracing integrator (SoA) — the XLA oracle.

Re-architecture of the reference's CUDA megakernel
(``radiance()`` radiance.cuh:21-79 + the render kernels main.cu:30-89).
The per-thread divergent bounce loop becomes a ``lax.while_loop`` over the
whole ray batch with an active-lane mask: miss, dead-throughput and
Russian-roulette "breaks" simply clear a lane's mask (SURVEY.md §7:
"masked wavefront/megakernel hybrid").  Ray batches are SoA Vec3s shaped
``[rows, 128]``.  Every other compute path (ops/megakernel.py) is tested
against this one.

Semantics matched to radiance.cuh line by line:
  * miss -> L += T * background, lane done           (radiance.cuh:27-30)
  * emissive hit, front-facing -> L += T * radiance  (radiance.cuh:35-43)
  * shading normal flipped toward the ray            (radiance.cuh:45-47)
  * pure-specular: T *= weight if max(weight) > 0 else done
  * otherwise: T *= value/pdf if max(value) > 0 and pdf > 0 else done
                                                     (radiance.cuh:49-63)
  * next ray tnear = 1e-4 (camera rays use 0)        (radiance.cuh:65)
  * Russian roulette after depth 5 with
    p = max(0.5, 1 - max(T))                         (radiance.cuh:68-74)
  * MAX_DEPTH = 50 bounces                           (radiance.cuh:12)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..models.device_scene import DeviceScene
from . import brdf, camera, rng, shade
from .bruteforce import BRUTE_FORCE_MAX_PRIMS, intersect_brute
from .trace import trace_occluded, trace_rays
from .vec import Vec3, dot, max_elem, where

MAX_DEPTH = 50          # radiance.cuh:12
RR_START_DEPTH = 5      # radiance.cuh:68
SECONDARY_TNEAR = 1e-4  # radiance.cuh:65
LANES = 128             # minor dim of every per-ray array


def intersect_scene(scene: DeviceScene, org: Vec3, dirn: Vec3, tnear):
    """Static dispatch: small scenes brute-force (zero gathers, zero inner
    loop — ops/bruteforce.py), large scenes walk the skip-link
    BVH (ops/trace.py).  ``scene.num_prims`` is static, so this `if`
    resolves at trace time."""
    if scene.num_prims <= BRUTE_FORCE_MAX_PRIMS:
        return intersect_brute(scene, org, dirn, tnear)
    return trace_rays(scene.bvh_nodes, org, dirn, tnear)


def _direct_point_lights(scene: DeviceScene, isect, n: Vec3, wi: Vec3,
                         mat, T: Vec3, active) -> Vec3:
    """Next-event estimation for point lights — the capability the
    reference parses but never exercises (SURVEY.md §3.5: point lights are
    uploaded yet the GPU integrator never samples them; its shadow-ray
    helpers scene.h:306-330 are dead code).  Deterministic (no RNG draws),
    so enabling it leaves every existing sample stream bit-identical.
    Returns the direct-lighting radiance to add."""
    num = int(scene.light_pos.shape[0])
    out = Vec3.zeros(wi.x.shape)
    for l in range(num):
        lp = Vec3(scene.light_pos[l, 0], scene.light_pos[l, 1],
                  scene.light_pos[l, 2])
        d = lp - isect.position
        dist2 = dot(d, d)
        dist = jnp.sqrt(dist2)
        wo = d * (1.0 / jnp.maximum(dist, 1e-20))
        ev = brdf.eval_brdf(mat, n, wi, wo)   # value includes cos/pi terms
        occ = trace_occluded(scene.bvh_nodes, isect.position, wo,
                             SECONDARY_TNEAR, dist * (1.0 - 1e-3))
        inten = Vec3(scene.light_intensity[l, 0],
                     scene.light_intensity[l, 1],
                     scene.light_intensity[l, 2])
        contrib = T * ev.value * inten * (1.0 / jnp.maximum(dist2, 1e-20))
        take = active & ~occ
        out = out + where(take, contrib, Vec3.zeros(wi.x.shape))
    return out


def _bounce(scene: DeviceScene, org, dirn, T, L, active, tnear, state,
            rr_depth, nee: bool = False,
            rr_start_depth: int = RR_START_DEPTH):
    """One shared bounce step (used by both loop variants).
    rr_depth: traced scalar depth for RR gating, or None to disable RR.
    nee: sample point lights at every hit (beyond-reference capability)."""
    prim, _t = intersect_scene(scene, org, dirn, tnear)

    miss = prim < 0
    bg = scene.background
    take_bg = active & miss
    L = L + where(take_bg, T * bg, Vec3.zeros(prim.shape))
    active = active & ~miss

    isect = shade.shade_setup(scene, prim, org, dirn, tnear)
    wi = -dirn
    cos_view = dot(wi, isect.shading_normal)

    front_emit = active & isect.is_emitter & (cos_view > 0.0)
    L = L + where(front_emit, T * isect.emission, Vec3.zeros(prim.shape))

    n = where(cos_view < 0.0, -isect.shading_normal, isect.shading_normal)

    mat = brdf.lookup_materials(scene, isect.material_id)

    if nee and int(scene.light_pos.shape[0]) > 0:
        L = L + _direct_point_lights(scene, isect, n, wi, mat, T, active)

    samp = brdf.sample_brdf(mat, n, wi, state)
    state = samp.state
    ev = brdf.eval_brdf(mat, n, wi, samp.wo)

    ok_spec = max_elem(samp.weight) > 0.0
    ok_scatter = (max_elem(ev.value) > 0.0) & (ev.pdf > 0.0)
    pdf_safe = jnp.where(ev.pdf > 0.0, ev.pdf, 1.0)
    contrib = where(samp.is_pure_specular, samp.weight, ev.value * (1.0 / pdf_safe))
    ok = jnp.where(samp.is_pure_specular, ok_spec, ok_scatter)

    upd = active & ok
    T = where(upd, T * contrib, T)
    active = active & ok

    org = where(active, isect.position, org)
    dirn = where(active, samp.wo, dirn)
    tnear = jnp.full_like(tnear, SECONDARY_TNEAR)

    # Russian roulette (radiance.cuh:68-74); the draw always happens so the
    # RNG streams of RR and no-RR variants stay aligned.
    state, u = rng.next_uniform(state)
    if rr_depth is not None:
        rr_on = rr_depth > rr_start_depth
        p = jnp.maximum(0.5, 1.0 - max_elem(T))
        kill = rr_on & (u < p)
        scale = 1.0 / jnp.where(rr_on & ~kill & (p < 1.0), 1.0 - p, 1.0)
        T = where(active & rr_on & ~kill, T * scale, T)
        active = active & ~kill

    return org, dirn, T, L, active, tnear, state


def radiance(scene: DeviceScene, org: Vec3, dirn: Vec3,
             state: jnp.ndarray, max_depth: int = MAX_DEPTH,
             nee: bool = False,
             rr_start_depth: int = RR_START_DEPTH) -> Vec3:
    """Path-traced radiance for a batch of rays.  org/dirn: Vec3 of
    [rows,128]; state: [rows,128] uint32 RNG.  Returns Vec3."""
    shape = state.shape
    L = Vec3.zeros(shape)
    T = Vec3.full(shape, (1.0, 1.0, 1.0))
    active = jnp.ones(shape, bool)
    tnear = jnp.zeros(shape, jnp.float32)  # camera rays: tnear = 0
    depth = jnp.int32(0)

    def cond(st):
        return (st[7] < max_depth) & jnp.any(st[4])

    def body(st):
        org, dirn, T, L, active, tnear, state, depth = st
        org, dirn, T, L, active, tnear, state = _bounce(
            scene, org, dirn, T, L, active, tnear, state, depth, nee,
            rr_start_depth)
        return org, dirn, T, L, active, tnear, state, depth + 1

    st = (org, dirn, T, L, active, tnear, state, depth)
    st = lax.while_loop(cond, body, st)
    return st[3]


def radiance_with_ray_count(scene: DeviceScene, org: Vec3, dirn: Vec3,
                            state: jnp.ndarray, max_depth: int = MAX_DEPTH,
                            nee: bool = False,
                            rr_start_depth: int = RR_START_DEPTH):
    """radiance() plus the number of rays actually traced (the camera ray
    and every surviving bounce ray; NEE shadow rays would add L per hit on
    top).  Feeds the Mrays/s metric (BASELINE.md north star is stated in
    rays/s, not samples/s): avg path length = rays / samples, so
    Mrays/s = Msamples/s x avg_path_length."""
    shape = state.shape
    L = Vec3.zeros(shape)
    T = Vec3.full(shape, (1.0, 1.0, 1.0))
    active = jnp.ones(shape, bool)
    tnear = jnp.zeros(shape, jnp.float32)
    depth = jnp.int32(0)
    nrays = jnp.zeros((), jnp.float32)

    def cond(st):
        return (st[7] < max_depth) & jnp.any(st[4])

    def body(st):
        org, dirn, T, L, active, tnear, state, depth, nrays = st
        nrays = nrays + jnp.sum(active.astype(jnp.float32))
        org, dirn, T, L, active, tnear, state = _bounce(
            scene, org, dirn, T, L, active, tnear, state, depth, nee,
            rr_start_depth)
        return org, dirn, T, L, active, tnear, state, depth + 1, nrays

    st = (org, dirn, T, L, active, tnear, state, depth, nrays)
    st = lax.while_loop(cond, body, st)
    return st[3], st[8]


@partial(jax.jit, static_argnames=("width", "height", "num_samples", "seed",
                                   "max_depth", "nee", "rr_start_depth"))
def measure_path_stats(scene: DeviceScene, cam_data: jnp.ndarray, width: int,
                       height: int, sample_start, num_samples: int = 1,
                       seed: int = 1984, max_depth: int = MAX_DEPTH,
                       nee: bool = False,
                       rr_start_depth: int = RR_START_DEPTH):
    """(total_rays, total_samples) over a frame — avg path length is their
    ratio.  Path length is a property of the scene + integrator semantics
    (radiance.cuh:24-77), not of the compute path, so the XLA oracle's
    count applies to the megakernel/wavefront/mx numbers too."""
    pix, valid, rows = _pixel_grid(width, height)
    i = (pix % width).astype(jnp.float32)
    j = (pix // width).astype(jnp.float32)

    def one_sample(k, acc):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        org, dirn = camera.generate_primary_rays(
            cam_data, (i + u1) / width, (j + u2) / height)
        # padding lanes (pix >= W*H) do trace; correct for them by ratio
        _, nrays = radiance_with_ray_count(scene, org, dirn, state,
                                           max_depth, nee, rr_start_depth)
        return acc + nrays

    total = lax.fori_loop(0, num_samples, one_sample,
                          jnp.zeros((), jnp.float32))
    frac_real = (width * height) / float(rows * LANES)
    return total * frac_real, jnp.float32(width * height * num_samples)


def radiance_fixed(scene: DeviceScene, org: Vec3, dirn: Vec3, state,
                   num_bounces: int, use_rr: bool = True,
                   nee: bool = False,
                   rr_start_depth: int = RR_START_DEPTH) -> Vec3:
    """Bounded-depth variant using ``lax.scan`` so reverse-mode autodiff
    works (while_loop is not reverse-differentiable).  With use_rr=True and
    num_bounces <= RR_START_DEPTH+1 it matches radiance() exactly."""
    shape = state.shape
    L = Vec3.zeros(shape)
    T = Vec3.full(shape, (1.0, 1.0, 1.0))
    active = jnp.ones(shape, bool)
    tnear = jnp.zeros(shape, jnp.float32)

    def body(carry, depth):
        org, dirn, T, L, active, tnear, state = carry
        out = _bounce(scene, org, dirn, T, L, active, tnear, state,
                      depth if use_rr else None, nee, rr_start_depth)
        return out, None

    carry = (org, dirn, T, L, active, tnear, state)
    carry, _ = lax.scan(body, carry, jnp.arange(num_bounces))
    return carry[3]


def _pixel_grid(width: int, height: int):
    """Flat pixel index layout [rows, 128] (padded), plus validity mask."""
    R = width * height
    rows = -(-R // LANES)
    pix = jnp.arange(rows * LANES, dtype=jnp.uint32).reshape(rows, LANES)
    valid = pix < R
    return pix, valid, rows


def render_pixel_sums(scene: DeviceScene, cam_data: jnp.ndarray,
                      pix: jnp.ndarray, width: int, height: int,
                      sample_start, num_samples: int = 1, seed: int = 1984,
                      max_depth: int = MAX_DEPTH,
                      nee: bool = False,
                      rr_start_depth: int = RR_START_DEPTH,
                      num_real=None) -> jnp.ndarray:
    """Core sample loop over an explicit pixel-index batch ``pix``
    ([rows, 128] uint32 flat indices).  Returns the per-pixel radiance SUM
    of ``num_samples`` fresh passes, shaped [rows, 128, 3].  This is the
    unit that multi-chip sharding partitions (parallel/sharding.py): each
    chip renders its own slab of pixel rows against a replicated scene."""
    i = (pix % width).astype(jnp.float32)
    j = (pix // width).astype(jnp.float32)

    def one_sample(k, acc):
        state = rng.seed_rays(pix, sample_start + k, seed)
        state, u1 = rng.next_uniform(state)
        state, u2 = rng.next_uniform(state)
        u = (i + u1) / width
        v = (j + u2) / height
        org, dirn = camera.generate_primary_rays(cam_data, u, v)
        L = radiance(scene, org, dirn, state, max_depth, nee,
                     rr_start_depth)
        out = L.to_array()
        if num_real is not None:
            # sample-sharded callers render a static ceil count per shard
            # but only the first ``num_real`` passes are wanted — masking
            # (not shrinking) keeps shapes static (parallel/sharding.py)
            out = jnp.where(k < num_real, out, 0.0)
        return acc + out

    init = jnp.zeros(pix.shape + (3,), jnp.float32)
    return lax.fori_loop(0, num_samples, one_sample, init)


@partial(jax.jit, static_argnames=("width", "height", "num_samples", "seed",
                                   "max_depth", "nee", "rr_start_depth"))
def render_samples(scene: DeviceScene, cam_data: jnp.ndarray, width: int,
                   height: int, sample_start: jnp.ndarray,
                   num_samples: int = 1, seed: int = 1984,
                   max_depth: int = MAX_DEPTH, nee: bool = False,
                   rr_start_depth: int = RR_START_DEPTH) -> jnp.ndarray:
    """Render ``num_samples`` full-image sample passes and return their SUM
    [H, W, 3] (the newSamples loop of render_progressive, main.cu:74-80).
    ``sample_start`` decorrelates RNG streams across frames (replaces the
    persistent curandState buffer)."""
    pix, valid, rows = _pixel_grid(width, height)
    acc = render_pixel_sums(scene, cam_data, pix, width, height,
                            sample_start, num_samples, seed, max_depth, nee,
                            rr_start_depth)
    acc = acc.reshape(rows * LANES, 3)[:width * height]
    return acc.reshape(height, width, 3)
