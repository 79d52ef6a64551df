"""Smoke test of the whole renderer on one GPU (or the sharded path on four).

Drives the entry points a user calls, at the reference's interactive
configuration (Cornell box, 640x480, 2 samples per pixel per frame, depth 50
with Russian roulette), in one process:

  1. the device must be a GPU; prints the card's name and power limit
  2. offline CLI (render/offline.py) on cbox at 640x480, 16 spp
  3. ProgressiveRenderer on cbox: 30 synced frames at 2 spp
  4. the web viewer in a thread: /state, /frame, an orbit /event
  5. the Triton megakernel against the XLA oracle on cbox and scene1
  6. the 144,046-triangle generated mesh through the BVH path, 3 frames
  7. scene1 with point-light NEE
  8. one inverse-rendering gradient step on scene1 at 640x480

``--cards 4`` runs only the sharded forward render and the sharded gradient
step on a 2x2 (samples x tiles) mesh, each compared with one card.

Any failure raises and ends the run with a non-zero exit.  The last line
of standard output is a JSON object naming the device.

Run:  python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(ROOT, "scenes")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
W, H, SPF = 640, 480, 2

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torrey.grad import inverse as inv  # noqa: E402
from torrey.models.device_scene import DeviceScene  # noqa: E402
from torrey.models.scenepack import load_scene  # noqa: E402
from torrey.ops import integrator, megakernel  # noqa: E402
from torrey.ops.camera import Camera, camera_ray_data  # noqa: E402
from torrey.parallel import sharding as sh  # noqa: E402
from torrey.render import offline  # noqa: E402
from torrey.render.renderer import ProgressiveRenderer  # noqa: E402
from torrey.utils.config import RenderConfig, setup_jax  # noqa: E402
from torrey.utils.image import read_png  # noqa: E402
from torrey.viewer.server import Viewer  # noqa: E402


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def scene_path(rel):
    return os.path.join(SCENES, rel)


def load(rel):
    pack, parsed = load_scene(scene_path(rel))
    cam = Camera.from_parsed(parsed.camera)
    return (jax.device_put(DeviceScene.from_pack(pack)),
            jnp.asarray(camera_ray_data(cam, W, H)))


def tiles(img, grid=(12, 16)):
    gh, gw = grid
    h, w = img.shape[:2]
    return img.reshape(gh, h // gh, gw, w // gw, 3).mean(axis=(1, 3))


def require_gpu():
    phase("device")
    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"no GPU: JAX found {devices[0].platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}",
          flush=True)
    return devices


def offline_cli():
    phase("offline CLI: cbox 640x480 16 spp")
    png = os.path.join(OUT, "cbox_offline.png")
    rc = offline.main([scene_path("cbox/cbox.xml"), "--spp", "16",
                       "--width", str(W), "--height", str(H), "-o", png])
    check(rc == 0, f"offline CLI returned {rc}")
    img = read_png(png).astype(np.float32)
    check(img.shape == (H, W, 3), f"PNG shape {img.shape}")
    check(np.isfinite(img).all() and img.std() > 1.0,
          "offline PNG is constant")


def progressive_cbox():
    phase("ProgressiveRenderer: cbox, 30 frames at 2 spp")
    r = ProgressiveRenderer.from_xml(scene_path("cbox/cbox.xml"), width=W,
                                     height=H)
    check(r.mode == "megakernel", f"cbox took the {r.mode} path")
    t0 = time.perf_counter()
    r.step()
    first = time.perf_counter() - t0
    times = []
    for _ in range(29):
        r.step()
        times.append(r.frame_ms)
    hdr = r.hdr()
    check(np.isfinite(hdr).all() and hdr.std() > 1e-3, "cbox frame")
    check(r.sample_count == 30 * SPF, f"{r.sample_count} samples")
    med = float(np.median(times))
    print(f"cbox megakernel: first frame {first:.3f} s (compile), median "
          f"synced frame {med:.3f} ms, {SPF * W * H / med / 1e3:.1f} "
          f"Msamples/s", flush=True)
    return r


def viewer(r):
    phase("viewer: /state, /frame, orbit /event")
    v = Viewer(r, port=0)
    v.start()
    try:
        base = f"http://127.0.0.1:{v.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                return resp.read()

        def post(ev):
            req = urllib.request.Request(base + "/event",
                                         data=json.dumps(ev).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read()

        deadline = time.time() + 60
        # enough samples that a reset is seen before they build up again
        while json.loads(get("/state"))["samples"] < 2000:
            check(time.time() < deadline, "viewer accumulated no samples")
            time.sleep(0.05)
        s0 = json.loads(get("/state"))
        frame = get("/frame")
        check(frame[:8] == b"\x89PNG\r\n\x1a\n", "/frame is not a PNG")
        post({"type": "orbit_begin", "x": 100, "y": 100})
        post({"type": "orbit_drag", "x": 220, "y": 130})
        post({"type": "orbit_end"})
        deadline = time.time() + 60
        while True:
            s1 = json.loads(get("/state"))
            moved = not np.allclose(s1["camera"]["lookfrom"],
                                    s0["camera"]["lookfrom"])
            if moved and s1["samples"] < s0["samples"]:
                break
            check(time.time() < deadline, "orbit did not move the camera "
                  "and reset the samples")
            time.sleep(0.02)
        print(f"viewer: {s0['samples']} samples at {s0['fps']} FPS before the"
              f" orbit, {s1['samples']} after it; camera "
              f"{s0['camera']['lookfrom']} -> {s1['camera']['lookfrom']}",
              flush=True)
    finally:
        v.stop()


def kernel_vs_oracle():
    phase("megakernel vs XLA oracle at 640x480")
    for rel in ("cbox/cbox.xml", "spheres/scene1.xml"):
        scene, cd = load(rel)
        start = jnp.uint32(0)
        # depth 3: per pixel.  The kernel's FMA contraction and operation
        # order differ from XLA's, which flips a triangle-edge or grazing
        # hit on a few pixels; at most 0.1% may differ by more than 1e-4.
        ref = np.asarray(integrator.render_samples(scene, cd, W, H, start,
                                                   SPF, max_depth=3))
        got = np.asarray(megakernel.render_samples_pallas(
            scene, cd, W, H, start, SPF, max_depth=3))
        share = float((np.abs(ref - got).max(-1) > 1e-4).mean())
        check(np.isfinite(got).all(), f"{rel}: non-finite kernel output")
        check(share <= 1e-3, f"{rel} depth 3: {share:.2e} of pixels differ")
        # depth 50 with RR: a flipped branch changes the rest of a path,
        # so compare 12x16 tile means against the Monte-Carlo noise of the
        # oracle itself (two sample streams of the same size)
        ref = np.asarray(integrator.render_samples(scene, cd, W, H, start,
                                                   SPF))
        other = np.asarray(integrator.render_samples(
            scene, cd, W, H, jnp.uint32(1000), SPF))
        got = np.asarray(megakernel.render_samples_pallas(
            scene, cd, W, H, start, SPF))
        noise = float(np.abs(tiles(ref) - tiles(other)).max())
        diff = float(np.abs(tiles(ref) - tiles(got)).max())
        check(np.isfinite(got).all(), f"{rel}: non-finite kernel output")
        check(diff < noise, f"{rel} depth 50: tile diff {diff:.2e} not "
              f"below the noise {noise:.2e}")
        print(f"{rel}: depth 3 {share:.2e} of pixels differ > 1e-4; depth 50"
              f" max tile diff {diff:.2e} (noise {noise:.2e})", flush=True)


def big_mesh():
    phase("144,046-triangle generated mesh, 3 frames through the BVH path")
    t0 = time.perf_counter()
    r = ProgressiveRenderer.from_xml(scene_path("bunny/bunny.xml"), width=W,
                                     height=H)
    setup = time.perf_counter() - t0
    check(r.scene.num_triangles == 144046,
          f"{r.scene.num_triangles} triangles")
    check(r.mode == "xla", f"bunny took the {r.mode} path")
    t0 = time.perf_counter()
    r.step()
    first = time.perf_counter() - t0
    times = []
    for _ in range(2):
        r.step()
        times.append(r.frame_ms)
    hdr = r.hdr()
    check(np.isfinite(hdr).all() and hdr.std() > 1e-3, "bunny frame")
    print(f"bunny: load+build {setup:.2f} s, first frame {first:.2f} s, "
          f"frames {times[0]:.1f} / {times[1]:.1f} ms", flush=True)


def nee_scene1():
    phase("scene1 with point-light NEE")
    cfg = RenderConfig(enable_nee=True)
    r = ProgressiveRenderer.from_xml(scene_path("spheres/scene1.xml"),
                                     config=cfg, width=W, height=H)
    check(r.mode == "megakernel", f"scene1 took the {r.mode} path")
    for _ in range(4):
        r.step()
    on = r.hdr()
    r0 = ProgressiveRenderer.from_xml(scene_path("spheres/scene1.xml"),
                                      width=W, height=H)
    for _ in range(4):
        r0.step()
    off = r0.hdr()
    check(np.isfinite(on).all(), "NEE frame is not finite")
    check(on.mean() > off.mean() + 1e-3, "NEE adds no light")
    scene, cd = load("spheres/scene1.xml")
    ref = np.asarray(integrator.render_samples(scene, cd, W, H,
                                               jnp.uint32(0), SPF,
                                               max_depth=3, nee=True))
    got = np.asarray(megakernel.render_samples_pallas(
        scene, cd, W, H, jnp.uint32(0), SPF, max_depth=3, nee=True))
    share = float((np.abs(ref - got).max(-1) > 1e-4).mean())
    check(share <= 1e-3, f"NEE depth 3: {share:.2e} of pixels differ")
    print(f"scene1 NEE: mean radiance {off.mean():.4f} -> {on.mean():.4f}; "
          f"kernel vs oracle {share:.2e} of pixels differ > 1e-4",
          flush=True)


def _grad_inputs(scene, cd, spp, bounces):
    """Parameters, pixel grid and a target rendered with half the red
    albedo, so the loss has signal."""
    params, _ = inv.split_params(scene)
    tweaked = dict(params, mat_r=params["mat_r"] * 0.5)
    pix, _ = sh._padded_grid(W, H, 1)
    pix = jnp.asarray(pix)
    render = jax.jit(lambda s: inv.render_pixels_diff(
        s, cd, pix, W, H, jnp.uint32(0), spp, num_bounces=bounces))
    target = render(inv.merge_params(scene, tweaked)) / spp
    return params, pix, target


def gradient_step():
    phase("inverse rendering: one loss_and_grad step, scene1 640x480")
    scene, cd = load("spheres/scene1.xml")
    spp = 1
    params, pix, target = _grad_inputs(scene, cd, spp, 6)
    t0 = time.perf_counter()
    loss, grads = inv.loss_and_grad(params, scene, cd, target, pix < W * H,
                                    pix, W, H, jnp.uint32(0), spp)
    loss = float(loss)
    dt = time.perf_counter() - t0
    check(np.isfinite(loss) and loss > 0, f"loss {loss}")
    for k, g in grads.items():
        check(bool(jnp.isfinite(g).all()), f"grad {k} not finite")
    check(float(jnp.abs(grads["mat_r"]).sum()) > 0, "mat_r grad is zero")
    print(f"gradient step: loss {loss:.4e}, {dt:.2f} s incl. compile",
          flush=True)


def sharded(devices):
    phase(f"sharded on {len(devices)} cards: 2x2 samples x tiles mesh")
    mesh = sh.make_mesh(devices, sample_parallel=2)
    one = sh.make_mesh(devices[:1])
    spp = 4
    for rel in ("cbox/cbox.xml", "spheres/scene1.xml"):
        scene, cd = load(rel)
        for mode in ("megakernel", "xla"):
            got = np.asarray(sh.render_samples_sharded(
                sh.replicate_scene(scene, mesh), cd, W, H, jnp.uint32(0),
                spp, mesh, mode=mode))
            ref = np.asarray(sh.render_samples_sharded(
                sh.replicate_scene(scene, one), cd, W, H, jnp.uint32(0),
                spp, one, mode=mode))
            err = float(np.abs(got - ref).max())
            # each pixel sums the same passes; only the psum's order differs
            check(err <= 1e-4 * max(1.0, float(np.abs(ref).max())),
                  f"{rel} {mode}: sharded differs from one card by {err}")
            print(f"{rel} {mode}: 4-card render matches one card "
                  f"(max abs diff {err:.2e})", flush=True)

    scene, cd = load("spheres/scene1.xml")
    params, pix, target = _grad_inputs(scene, cd, spp, 6)
    loss1, grads1 = inv.loss_and_grad(params, scene, cd, target, pix < W * H,
                                      pix, W, H, jnp.uint32(0), spp)
    from jax.sharding import NamedSharding, PartitionSpec as P
    scene_m = sh.replicate_scene(scene, mesh)
    params_m = jax.device_put(params, NamedSharding(mesh, P()))
    step = inv.make_sharded_loss_and_grad(mesh, W, H, spp)
    img = np.asarray(target).reshape(-1, 3)[:W * H].reshape(H, W, 3)
    pix_s, tgt_s, valid_s = inv.shard_grid_inputs(mesh, img)
    loss4, grads4 = step(params_m, scene_m, cd, tgt_s, valid_s, pix_s,
                         jnp.uint32(0))
    check(abs(float(loss4) - float(loss1)) <= 1e-4 * abs(float(loss1)),
          f"sharded loss {float(loss4)} vs {float(loss1)}")
    # a parameter with no real gradient (0) can pick up fp noise from the
    # psum order, so the absolute tolerance scales with the largest grad
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads1.values())
    for k in grads1:
        a, b = np.asarray(grads4[k]), np.asarray(grads1[k])
        check(np.allclose(a, b, rtol=1e-3, atol=1e-6 * scale),
              f"sharded grad {k} differs")
    print(f"sharded gradient step matches one card: loss {float(loss4):.6e}"
          f" vs {float(loss1):.6e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    setup_jax()
    os.makedirs(OUT, exist_ok=True)
    devices = require_gpu()
    if args.cards == 4:
        check(len(devices) >= 4, f"{len(devices)} cards visible")
        devices = devices[:4]
        sharded(devices)
    else:
        devices = devices[:1]
        offline_cli()
        r = progressive_cbox()
        viewer(r)
        kernel_vs_oracle()
        big_mesh()
        nee_scene1()
        gradient_step()
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
