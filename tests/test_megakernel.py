"""Triton megakernel vs XLA integrator parity.

The megakernel (ops/megakernel.py) must agree with the XLA path: identical
RNG streams, identical draw order and identical bounce logic
(radiance.cuh:21-79 semantics).  These tests run the kernel in the Pallas
interpreter, so they work on the CPU test platform; chip_smoke.py runs the
same comparisons with the kernel compiled for the GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops import integrator, megakernel
from torrey.ops.camera import Camera, camera_ray_data

W, H = 128, 96


def _load(scenes_dir, rel):
    pack, parsed = load_scene(f"{scenes_dir}/{rel}")
    scene = DeviceScene.from_pack(pack)
    cam = Camera.from_parsed(parsed.camera)
    cd = jnp.asarray(camera_ray_data(cam, W, H))
    return scene, cd


@pytest.mark.parametrize("rel", [
    "spheres/scene1.xml",           # diffuse+mirror spheres, background
    "spheres/scene0_spherical_light.xml",   # area light
    "cbox/cbox.xml",                # triangle meshes + area light
])
def test_megakernel_matches_xla_shallow(scenes_dir, rel):
    """Strict parity at shallow depth.  The two paths are the same math in
    different compilations, so 1-ulp fma/fusion differences exist; at
    depth <= 4 they stay at the ulp level except where one flips a hit on
    a triangle edge."""
    scene, cd = _load(scenes_dir, rel)
    spp, depth = 2, 4
    ref = np.asarray(integrator.render_samples(
        scene, cd, W, H, 0, spp, max_depth=depth))
    got = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 0, spp, max_depth=depth, interpret=True))
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    # a 1-ulp seed can still flip a triangle-edge hit on isolated pixels
    assert bad.mean() < 1e-4, f"{bad.mean():%} of elements mismatch"
    assert np.abs(ref - got).mean() < 1e-4


@pytest.mark.parametrize("rel", ["spheres/scene1.xml", "cbox/cbox.xml"])
def test_megakernel_matches_xla_deep_statistical(scenes_dir, rel):
    """At full depth, a 1-ulp seed can flip a discrete event (hit selection
    on a triangle edge, RR survival) on isolated pixels, so deep parity is
    statistical: almost every pixel identical, mean error at noise level."""
    scene, cd = _load(scenes_dir, rel)
    spp, depth = 2, 12
    ref = np.asarray(integrator.render_samples(
        scene, cd, W, H, 0, spp, max_depth=depth))
    got = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 0, spp, max_depth=depth, interpret=True))
    d = np.abs(ref - got).max(axis=-1)
    assert (d > 1e-3).mean() < 2e-3       # <0.2% of pixels flipped
    assert np.abs(ref - got).mean() < 1e-3
    assert abs(ref.mean() - got.mean()) < 1e-3


def test_megakernel_sample_start_decorrelates(scenes_dir):
    scene, cd = _load(scenes_dir, "spheres/scene1.xml")
    a = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 0, 1, max_depth=4, interpret=True))
    b = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 1, 1, max_depth=4, interpret=True))
    assert np.abs(a - b).max() > 1e-3  # different sample streams
    # and reproducible
    a2 = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 0, 1, max_depth=4, interpret=True))
    np.testing.assert_array_equal(a, a2)


@pytest.mark.parametrize("blk0", [0, 5])
def test_render_blocks_range_matches_full_render(scenes_dir, blk0):
    """Tile sharding renders a range of blocks per device: blocks
    [blk0, blk0 + 4) equal those pixels of the whole-image render."""
    scene, cd = _load(scenes_dir, "cbox/cbox.xml")
    params = megakernel.pack_params(cd, megakernel.scene_background(scene))
    r, g, b = megakernel.render_blocks(
        scene.prim_rows, params, 2, blk0, 3, W, H, 4, 1984, 6,
        scene.num_spheres, scene.num_triangles, interpret=True)
    B = megakernel.BLOCK
    assert r.shape == (4 * B,)
    full = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, 2, 3, max_depth=6, interpret=True)).reshape(-1, 3)
    np.testing.assert_array_equal(np.stack([r, g, b], -1),
                                  full[blk0 * B:(blk0 + 4) * B])


def test_padding_lanes_render_nothing(scenes_dir):
    """The last block runs past the image; its extra lanes stay zero."""
    w, h = 10, 7          # 70 pixels: two 64-ray blocks, 58 padding lanes
    pack, parsed = load_scene(f"{scenes_dir}/spheres/scene1.xml")
    scene = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), w, h))
    params = megakernel.pack_params(cd, megakernel.scene_background(scene))
    n = megakernel.total_blocks(w, h)
    r, g, b = megakernel.render_blocks(
        scene.prim_rows, params, 0, 0, 2, w, h, n, 1984, 4,
        scene.num_spheres, scene.num_triangles, interpret=True)
    out = np.stack([r, g, b], -1)
    assert out.shape == (n * megakernel.BLOCK, 3)
    assert (out[w * h:] == 0).all() and (out[:w * h] > 0).any()
    ref = np.asarray(integrator.render_samples(scene, cd, w, h, 0, 2,
                                               max_depth=4))
    np.testing.assert_allclose(out[:w * h].reshape(h, w, 3), ref,
                               rtol=1e-5, atol=1e-5)
