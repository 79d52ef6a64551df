"""Differentiable-rendering tests: finite-difference validation of pixel
gradients (BASELINE.md north star) and single-chip vs sharded agreement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torrey.grad import inverse as inv
from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops.camera import Camera, camera_ray_data
from torrey.parallel import sharding as sh

W, H, SPP, BOUNCES = 32, 24, 2, 3


@pytest.fixture(scope="module")
def setup(scenes_dir):
    pack, parsed = load_scene(f"{scenes_dir}/spheres/scene1.xml")
    scene = DeviceScene.from_pack(pack)
    cam = Camera.from_parsed(parsed.camera)
    cd = jnp.asarray(camera_ray_data(cam, W, H))
    pix, _ = sh._padded_grid(W, H, 1)
    pix = jnp.asarray(pix)
    # target = a render with different albedo, so the loss has signal
    params0, _ = inv.split_params(scene)
    tweaked = dict(params0)
    tweaked["mat_r"] = params0["mat_r"] * 0.5
    # same RNG stream (sample_start=0) as the optimized renders, so the
    # loss has no Monte-Carlo noise floor and is exactly fittable
    target_acc = inv.render_pixels_diff(
        inv.merge_params(scene, tweaked), cd, pix, W, H, jnp.uint32(0),
        SPP, num_bounces=BOUNCES)
    target_grid = target_acc / SPP
    valid = pix < W * H
    return scene, cd, pix, target_grid, valid, params0


def _loss(setup_t, params):
    scene, cd, pix, target_grid, valid, _ = setup_t
    loss, _ = inv.loss_and_grad(params, scene, cd, target_grid, valid, pix,
                                W, H, jnp.uint32(0), SPP,
                                num_bounces=BOUNCES)
    return float(loss)


def test_grad_matches_finite_difference(setup):
    scene, cd, pix, target_grid, valid, params0 = setup
    loss, grads = inv.loss_and_grad(params0, scene, cd, target_grid, valid,
                                    pix, W, H, jnp.uint32(0), SPP,
                                    num_bounces=BOUNCES)
    assert float(loss) > 0

    # central finite differences on a few scalar entries.  light_intensity
    # is reachable only through NEE (auto-enabled: scene1 has point
    # lights), so its inclusion guards against the silently-dead-parameter
    # regression (NEE not threaded through the diff path).
    checked = 0
    for key in ("mat_r", "mat_g", "bg_r", "light_intensity"):
        g = np.asarray(grads[key])
        arr = np.asarray(params0[key], np.float64)
        for idx in range(min(arr.size, 2)):
            eps = 5e-3
            pp = dict(params0)
            vec = arr.copy()
            vec[np.unravel_index(idx, arr.shape)] += eps
            pp[key] = jnp.asarray(vec, jnp.float32)
            lp = _loss(setup, pp)
            vec = arr.copy()
            vec[np.unravel_index(idx, arr.shape)] -= eps
            pp[key] = jnp.asarray(vec, jnp.float32)
            lm = _loss(setup, pp)
            fd = (lp - lm) / (2 * eps)
            an = g.flat[idx]
            assert abs(fd - an) <= 2e-3 + 0.08 * max(abs(fd), abs(an)), \
                (key, idx, fd, an)
            checked += 1
    assert checked >= 6
    assert np.any(np.asarray(grads["light_intensity"]) != 0.0), \
        "light_intensity gradient must be live when the scene has point lights"


def test_gradient_descent_reduces_loss(setup):
    scene, cd, pix, target_grid, valid, params0 = setup
    import optax
    params = dict(params0)
    opt = optax.adam(5e-2)
    opt_state = opt.init(params)
    losses = []
    for it in range(30):
        loss, grads = inv.loss_and_grad(params, scene, cd, target_grid,
                                        valid, pix, W, H, jnp.uint32(0),
                                        SPP, num_bounces=BOUNCES)
        losses.append(float(loss))
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    assert losses[-1] < losses[0] * 0.2, losses


def test_sharded_grad_matches_single(setup):
    scene, cd, pix, target_grid, valid, params0 = setup
    loss1, grads1 = inv.loss_and_grad(params0, scene, cd, target_grid,
                                      valid, pix, W, H, jnp.uint32(0), SPP,
                                      num_bounces=BOUNCES)
    mesh = sh.make_mesh(sample_parallel=2)
    step = inv.make_sharded_loss_and_grad(mesh, W, H, SPP,
                                          num_bounces=BOUNCES)
    scene_r = sh.replicate_scene(scene, mesh)
    params_r = jax.device_put(
        params0, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    target_img = np.zeros((H, W, 3), np.float32)
    tg = np.asarray(target_grid).reshape(-1, 3)[:W * H]
    target_img[:] = tg.reshape(H, W, 3)
    pix_s, tgt_s, valid_s = inv.shard_grid_inputs(mesh, target_img)
    lossN, gradsN = step(params_r, scene_r, cd, tgt_s, valid_s, pix_s,
                         jnp.uint32(0))
    np.testing.assert_allclose(float(lossN), float(loss1), rtol=1e-4)
    for k in grads1:
        np.testing.assert_allclose(np.asarray(gradsN[k]),
                                   np.asarray(grads1[k]),
                                   rtol=2e-4, atol=1e-6)
