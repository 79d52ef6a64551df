"""Multi-device sharding tests on the 8-virtual-device CPU mesh
(SURVEY.md §4e).  The sharded render must agree with the single-device
render bit-for-bit in sample content: tile sharding only partitions pixel
rows, and sample sharding partitions the same sample indices, so the
radiance sums match to fp-reduction tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops.camera import Camera, camera_ray_data
from torrey.ops.integrator import render_samples
from torrey.parallel import sharding as sh

W, H, SPP = 64, 48, 4


@pytest.fixture(scope="module")
def sphere_scene(scenes_dir):
    pack, parsed = load_scene(f"{scenes_dir}/spheres/scene1.xml")
    scene = DeviceScene.from_pack(pack)
    cam = Camera.from_parsed(parsed.camera)
    cd = jnp.asarray(camera_ray_data(cam, W, H))
    return scene, cd


@pytest.mark.parametrize("sample_parallel", [1, 2, 4, 8])
def test_sharded_matches_single(sphere_scene, sample_parallel):
    scene, cd = sphere_scene
    mesh = sh.make_mesh(sample_parallel=sample_parallel)
    scene_r = sh.replicate_scene(scene, mesh)
    img = np.asarray(sh.render_samples_sharded(
        scene_r, cd, W, H, jnp.uint32(0), SPP, mesh))
    assert img.shape == (H, W, 3)
    ref = np.asarray(render_samples(scene, cd, W, H, jnp.uint32(0), SPP))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spp", [1, 3, 5])
def test_sharded_exact_samples_with_remainder(sphere_scene, spp):
    """Sample counts that do NOT divide the sample axis must still return
    the sum of exactly ``spp`` passes (surplus ceil passes are masked)."""
    scene, cd = sphere_scene
    mesh = sh.make_mesh(sample_parallel=4)
    scene_r = sh.replicate_scene(scene, mesh)
    img = np.asarray(sh.render_samples_sharded(
        scene_r, cd, W, H, jnp.uint32(0), spp, mesh))
    ref = np.asarray(render_samples(scene, cd, W, H, jnp.uint32(0), spp))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)
    assert sh.effective_samples(spp, mesh) == spp


def test_mesh_shape_validation():
    with pytest.raises(ValueError):
        sh.make_mesh(sample_parallel=3)  # 8 devices % 3 != 0


def test_tile_padding_covers_image():
    pix, rows = sh._padded_grid(33, 7, 8)
    assert rows % 8 == 0
    assert pix.size >= 33 * 7
    assert pix[0, 0] == 0 and pix.flat[33 * 7 - 1] == 33 * 7 - 1


# --- the megakernel inside shard_map (Pallas interpreter on the CPU mesh;
# on GPUs the same code runs the compiled Triton kernel) -----------------

@pytest.mark.parametrize("sample_parallel", [1, 4])
def test_sharded_megakernel_matches_single(sphere_scene, sample_parallel):
    from torrey.ops.megakernel import render_samples_pallas
    scene, cd = sphere_scene
    mesh = sh.make_mesh(sample_parallel=sample_parallel)
    scene_r = sh.replicate_scene(scene, mesh)
    img = np.asarray(sh.render_samples_sharded(
        scene_r, cd, W, H, jnp.uint32(0), 3, mesh, mode="megakernel",
        interpret=True))
    ref = np.asarray(render_samples_pallas(
        scene, cd, W, H, jnp.uint32(0), 3, interpret=True))
    # per-pixel computation is identical per block; psum only adds zeros
    np.testing.assert_allclose(img, ref, rtol=1e-6, atol=1e-6)
