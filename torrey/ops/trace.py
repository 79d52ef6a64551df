"""Wavefront BVH traversal in XLA (large scenes).

Replacement for the reference's per-thread stack-based CUDA traversal
(scene.h:246-301, 64-deep local stack).  Whole-array XLA code advances
all rays in lockstep, so per-lane stacks do not fit; instead the BVH is
flattened to preorder with skip links (models/bvh.py) and every ray
carries a single int32 cursor:

    internal node, box hit   -> cursor + 1     (descend)
    internal node, box miss  -> skip[cursor]   (skip subtree)
    leaf (test its primitive)-> skip[cursor]

One ``lax.while_loop`` iteration advances EVERY ray by one node; finished
rays (cursor == N) are masked.  Each step performs one 64-byte "fat node"
row gather (box/edges + int lanes, see models/scenepack.py), then evaluates
box, triangle and sphere tests branchlessly and selects by node kind.

Rays are SoA ``Vec3`` of ``[rows, 128]`` components; cursors/hits share
that shape.

Traversal is gradient-stopped: hit ids are discrete, so autodiff flows
through the differentiable re-intersection in ops/shade.py instead
(SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import geometry as g
from .vec import Vec3


def _traverse(bvh_nodes, org: Vec3, dirn: Vec3, tnear, t_limit):
    N = bvh_nodes.shape[0]
    shape = org.x.shape
    inv_dir = Vec3(1.0 / dirn.x, 1.0 / dirn.y, 1.0 / dirn.z)

    idx0 = jnp.zeros(shape, jnp.int32)
    t_max0 = jnp.full(shape, jnp.inf, jnp.float32) if t_limit is None \
        else jnp.broadcast_to(t_limit, shape).astype(jnp.float32)
    hit0 = jnp.full(shape, -1, jnp.int32)
    tnear = jnp.broadcast_to(tnear, shape).astype(jnp.float32)

    def cond(state):
        idx, _, _ = state
        return jnp.any(idx < N)

    def body(state):
        idx, t_max, hit = state
        alive = idx < N
        safe_idx = jnp.minimum(idx, N - 1)
        row = jnp.take(bvh_nodes, safe_idx, axis=0)   # [rows,128,16]
        a = Vec3(row[..., 0], row[..., 1], row[..., 2])
        b = Vec3(row[..., 3], row[..., 4], row[..., 5])
        c = Vec3(row[..., 6], row[..., 7], row[..., 8])
        ints = lax.bitcast_convert_type(row[..., 12:15], jnp.int32)
        skip, prim, kind = ints[..., 0], ints[..., 1], ints[..., 2]

        is_internal = kind == 0
        is_tri = kind == 1
        is_sph = kind == 2

        box_hit = g.slab_test(org, inv_dir, a, b, t_max)
        t_tri, _, _, hit_tri = g.intersect_triangle(a, b, c, org, dirn,
                                                    tnear, t_max)
        t_sph, hit_sph = g.intersect_sphere(a, b.x, org, dirn, tnear, t_max)

        prim_hit = alive & ((is_tri & hit_tri) | (is_sph & hit_sph))
        prim_t = jnp.where(is_tri, t_tri, t_sph)
        closer = prim_hit & (prim_t < t_max)
        t_max = jnp.where(closer, prim_t, t_max)
        hit = jnp.where(closer, prim, hit)

        descend = is_internal & box_hit
        nxt = jnp.where(descend, idx + 1, skip)
        idx = jnp.where(alive, nxt, idx)
        return idx, t_max, hit

    _, t_max, hit = lax.while_loop(cond, body, (idx0, t_max0, hit0))
    return hit, t_max


# Rows per traversal chunk.  The while_loop advances every ray in a chunk
# until the chunk's WORST ray finishes, so chunk size bounds how much
# lockstep divergence one straggler can cost: with the full image in one
# chunk a single deep ray (max ~800 node visits on bunny vs median 44)
# stalls 300k rays; 32-row chunks (4096 rays, a coherent screen band) pay
# each band's own max only.
TRACE_CHUNK_ROWS = 32


def _traverse_chunked(bvh_nodes, org: Vec3, dirn: Vec3, tnear, t_limit):
    rows = org.x.shape[0]
    if rows <= TRACE_CHUNK_ROWS or rows % TRACE_CHUNK_ROWS != 0:
        return _traverse(bvh_nodes, org, dirn, tnear, t_limit)

    G = rows // TRACE_CHUNK_ROWS

    def split(a):
        return a.reshape((G, TRACE_CHUNK_ROWS) + a.shape[1:])

    tnear = jnp.broadcast_to(tnear, org.x.shape).astype(jnp.float32)
    xs = [split(a) for a in (*org, *dirn, tnear)]
    if t_limit is not None:
        xs.append(split(jnp.broadcast_to(t_limit, org.x.shape)
                        .astype(jnp.float32)))

    def body(_, chunk):
        o = Vec3(chunk[0], chunk[1], chunk[2])
        d = Vec3(chunk[3], chunk[4], chunk[5])
        tl = chunk[7] if t_limit is not None else None
        hit, t = _traverse(bvh_nodes, o, d, chunk[6], tl)
        return None, (hit, t)

    _, (hit, t) = lax.scan(body, None, xs)
    return (hit.reshape(org.x.shape), t.reshape(org.x.shape))


def trace_rays(bvh_nodes, org: Vec3, dirn: Vec3, tnear):
    """Closest-hit query.  Returns (prim_id [rows,128] i32, t); prim_id is
    -1 on miss.  Non-differentiable: all inputs gradient-stopped, so the
    while_loop is constant under autodiff."""
    sg = lax.stop_gradient
    return _traverse_chunked(sg(bvh_nodes), Vec3(*sg(tuple(org))),
                             Vec3(*sg(tuple(dirn))), sg(tnear), None)


def trace_occluded(bvh_nodes, org: Vec3, dirn: Vec3, tnear, t_limit):
    """Any-hit query for shadow rays (the reference carries this as dead
    code in scene.h:306-330; ours backs the NEE extension)."""
    sg = lax.stop_gradient
    hit, _ = _traverse(sg(bvh_nodes), Vec3(*sg(tuple(org))),
                       Vec3(*sg(tuple(dirn))), sg(tnear), sg(t_limit))
    return hit >= 0
