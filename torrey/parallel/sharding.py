"""Multi-device rendering: tile + sample sharding over a device mesh.

The reference is single-process single-GPU with zero inter-device
communication (SURVEY.md §2 "Parallelism strategies"); its one parallelism
axis is the CUDA thread grid over pixels (main.cu:220-227).  Across several
devices this module adds a 2-axis ``jax.sharding.Mesh``:

  * ``tiles``   — pixel-row slabs sharded across devices (the data-parallel
                  axis; each device renders its own rows, no communication).
  * ``samples`` — the per-pixel sample batch split across devices; partial
                  radiance sums are reduced with one ``psum``.

Scene buffers (BVH, vertex pools, material tables) are *replicated* on
every device — the analog of the reference keeping its whole scene resident
on the one GPU (scene.h:73-142).  The only collective in the forward path
is the sample-axis ``psum``; gradients of scene parameters in the
differentiable path additionally ``psum`` over both axes
(grad/inverse.py).  Multi-host runs ride the same code: call
``jax.distributed.initialize()`` first and pass the global mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.device_scene import DeviceScene
from ..ops.integrator import LANES, MAX_DEPTH, render_pixel_sums

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(devices=None, sample_parallel: int = 1) -> Mesh:
    """Build the (samples, tiles) mesh.  ``sample_parallel`` devices share
    each pixel slab and split the sample batch; the rest shard tiles.
    Defaults to all visible devices, pure tile sharding."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % sample_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"sample_parallel={sample_parallel}")
    arr = np.asarray(devices).reshape(sample_parallel, n // sample_parallel)
    return Mesh(arr, (SAMPLE_AXIS, TILE_AXIS))


def replicate_scene(scene: DeviceScene, mesh: Mesh) -> DeviceScene:
    """Place every scene leaf on all mesh devices, fully replicated — the
    device_put that plays the role of GPUScene::copyFrom (scene.h:73-142)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(scene, sharding)


def _padded_grid(width: int, height: int, n_tiles: int):
    """Flat pixel grid [rows, LANES] padded so rows divide n_tiles."""
    R = width * height
    rows = -(-R // LANES)
    rows = -(-rows // n_tiles) * n_tiles
    pix = np.arange(rows * LANES, dtype=np.uint32).reshape(rows, LANES)
    return pix, rows


@partial(jax.jit,
         static_argnames=("width", "height", "num_samples", "seed",
                          "max_depth", "mesh", "nee"))
def _render_sharded(scene, cam_data, pix, sample_start, width, height,
                    num_samples, seed, max_depth, mesh, nee=False):
    ns_total = num_samples
    ns_shard = mesh.shape[SAMPLE_AXIS]
    ns_local = -(-ns_total // ns_shard)  # static ceil per shard

    def shard_fn(scene, cam_data, pix, sample_start):
        s_idx = lax.axis_index(SAMPLE_AXIS)
        local_start = sample_start + (s_idx * ns_local).astype(jnp.uint32)
        # every shard runs the same static ns_local passes, but passes past
        # the global num_samples are masked to zero, so the psum'd result
        # covers EXACTLY num_samples (a caller dividing by num_samples is
        # always correct)
        n_real = jnp.clip(ns_total - s_idx * ns_local, 0, ns_local)
        acc = render_pixel_sums(scene, cam_data, pix, width, height,
                                local_start, ns_local, seed, max_depth,
                                nee=nee, num_real=n_real)
        return lax.psum(acc, SAMPLE_AXIS)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS, None), P()),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False)
    return fn(scene, cam_data, pix, sample_start)


@partial(jax.jit,
         static_argnames=("width", "height", "num_samples", "seed",
                          "max_depth", "mesh", "interpret", "rr_start_depth",
                          "nee"))
def _render_sharded_megakernel(scene, cam_data, sample_start, width, height,
                               num_samples, seed, max_depth, mesh,
                               interpret=False, rr_start_depth=5, nee=False):
    """Tile+sample sharding of the Triton megakernel: each device renders
    its own range of blocks (bit-identical per pixel to the one-device
    kernel) and its slice of the sample batch; partial sums psum over the
    sample axis and block ranges concatenate over the tile axis."""
    from ..ops import megakernel as mk
    n_tiles = mesh.shape[TILE_AXIS]
    ns_local = -(-num_samples // mesh.shape[SAMPLE_AXIS])
    blocks_local = -(-mk.total_blocks(width, height) // n_tiles)
    params = mk.pack_params(cam_data, mk.scene_background(scene))

    def shard_fn(scene, params, sample_start):
        t_idx = lax.axis_index(TILE_AXIS)
        s_idx = lax.axis_index(SAMPLE_AXIS)
        local_start = sample_start + (s_idx * ns_local).astype(jnp.uint32)
        num_real = jnp.clip(num_samples - s_idx * ns_local, 0, ns_local)
        light_rows = mk.pack_light_rows(scene) if nee else None
        r, g, b = mk.render_blocks(
            scene.prim_rows, params, local_start, t_idx * blocks_local,
            num_real, width, height, blocks_local, seed, max_depth,
            scene.num_spheres, scene.num_triangles, interpret,
            rr_start_depth, light_rows)
        return (lax.psum(r, SAMPLE_AXIS), lax.psum(g, SAMPLE_AXIS),
                lax.psum(b, SAMPLE_AXIS))

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(), P(), P()),
                       out_specs=(P(TILE_AXIS),) * 3,
                       check_vma=False)
    r, g, b = fn(scene, params, sample_start)
    R = width * height
    return jnp.stack([r[:R], g[:R], b[:R]], axis=-1).reshape(height, width,
                                                             3)


def render_samples_sharded(scene, cam_data, width: int,
                           height: int, sample_start, num_samples: int,
                           mesh: Mesh, seed: int = 1984,
                           max_depth: int = MAX_DEPTH, mode: str = "xla",
                           interpret: bool = False,
                           rr_start_depth: int = 5,
                           nee: bool = False) -> jnp.ndarray:
    """Sharded render dispatch: returns the [H, W, 3] radiance sum of
    EXACTLY ``num_samples`` passes, computed across the mesh (per-device
    pass counts ceil-round, but the surplus passes are masked out of the
    sum).

    ``mode`` picks the per-device compute path, the same two the
    one-device renderer dispatches (render/renderer.py::render_mode):
      * "xla"        — oracle integrator (DeviceScene)
      * "megakernel" — Triton kernel (DeviceScene, <= 512 primitives)
    ``interpret=True`` runs the megakernel in the Pallas interpreter (CPU
    mesh tests)."""
    start = jnp.asarray(sample_start, jnp.uint32)
    if mode == "megakernel":
        return _render_sharded_megakernel(
            scene, cam_data, start, width, height, num_samples, seed,
            max_depth, mesh, interpret, rr_start_depth, nee)

    n_tiles = mesh.shape[TILE_AXIS]
    pix, rows = _padded_grid(width, height, n_tiles)
    pix_sharded = jax.device_put(
        jnp.asarray(pix), NamedSharding(mesh, P(TILE_AXIS, None)))
    acc = _render_sharded(scene, cam_data, pix_sharded, start,
                          width, height, num_samples, seed, max_depth, mesh,
                          nee)
    acc = acc.reshape(rows * LANES, 3)[:width * height]
    return acc.reshape(height, width, 3)


def effective_samples(num_samples: int, mesh: Mesh) -> int:
    """Samples in the sum render_samples_sharded returns.  Since surplus
    ceil-rounded passes are masked, this is now always ``num_samples``;
    kept for API compatibility."""
    del mesh
    return num_samples
