"""Progressive renderer: accumulation + camera-reset controller.

The reference's frame loop state machine (main.cu:272-344, C26/C27 in
SURVEY.md): keep a running radiance sum in a device buffer, add
``samples_per_frame`` fresh samples per step, divide by the count for
display, and zero everything when the camera (or the spf setting) changes —
camera compare with epsilon 1e-5 (main.cu:297-312).

The accumulation buffer is *donated* through the jitted step so XLA updates
it in place (the analog of the persistent ``accumulationBuffer`` in managed
memory, main.cu:213-218).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.device_scene import DeviceScene
from ..models.scenepack import ScenePack, load_scene
from ..ops.camera import Camera, camera_ray_data
from ..ops.integrator import render_samples
from ..ops.megakernel import MEGAKERNEL_MAX_PRIMS, render_samples_pallas
from ..utils import image as img_util
from ..utils.config import RenderConfig, setup_jax


def render_mode(num_prims: int, platform: str) -> str:
    """The compute path for a scene: "megakernel" (the Triton kernel,
    ops/megakernel.py) for scenes of at most MEGAKERNEL_MAX_PRIMS
    primitives on a GPU, else "xla" (ops/integrator.py: brute force up to
    512 primitives, BVH traversal above).  The CPU, the test platform,
    always takes "xla"."""
    if platform == "gpu" and num_prims <= MEGAKERNEL_MAX_PRIMS:
        return "megakernel"
    return "xla"


@partial(jax.jit, static_argnames=("width", "height", "num_samples", "seed",
                                   "max_depth", "mode", "nee",
                                   "rr_start_depth"),
         donate_argnames=("accum",))
def _accumulate_step(scene, cam_data, accum, sample_start,
                     width: int, height: int, num_samples: int, seed: int,
                     max_depth: int, mode: str, nee: bool = False,
                     rr_start_depth: int = 5):
    if mode == "megakernel":
        new = render_samples_pallas(scene, cam_data, width, height,
                                    sample_start, num_samples, seed,
                                    max_depth, rr_start_depth=rr_start_depth,
                                    nee=nee)
    else:
        new = render_samples(scene, cam_data, width, height, sample_start,
                             num_samples, seed, max_depth, nee,
                             rr_start_depth)
    return accum + new


class ProgressiveRenderer:
    """Host-side controller.  Owns the device scene, current camera, the
    accumulation buffer and the sample count."""

    def __init__(self, scene: ScenePack, camera: Camera, width: int,
                 height: int, config: RenderConfig = RenderConfig()):
        setup_jax()
        self.mode = render_mode(scene.num_prims, jax.default_backend())
        if isinstance(scene, ScenePack):
            scene = DeviceScene.from_pack(scene)
        self.scene = jax.device_put(scene)
        self.camera = camera
        self.initial_camera = camera
        self.width = width
        self.height = height
        self.config = config
        self.samples_per_frame = config.samples_per_frame
        self._cam_data = jnp.asarray(camera_ray_data(camera, width, height))
        self.accum = jnp.zeros((height, width, 3), jnp.float32)
        self.sample_count = 0
        self.frame_ms = 0.0

    @classmethod
    def from_xml(cls, xml_path: str,
                 config: RenderConfig = RenderConfig(),
                 width: Optional[int] = None,
                 height: Optional[int] = None) -> "ProgressiveRenderer":
        pack, parsed = load_scene(xml_path)
        cam = Camera.from_parsed(parsed.camera)
        return cls(pack, cam, width or parsed.camera.width,
                   height or parsed.camera.height, config)

    # -- camera interaction (main.cu:297-324 semantics) -----------------
    def set_camera(self, camera: Camera) -> None:
        if not camera.almost_equal(self.camera, self.config.camera_epsilon):
            self.camera = camera
            self._cam_data = jnp.asarray(
                camera_ray_data(camera, self.width, self.height))
            self.reset_accumulation()

    def reset_camera(self) -> None:
        """'R' key / Reset button (imgui_manager.cpp:289-307)."""
        self.set_camera(self.initial_camera)

    def set_samples_per_frame(self, spf: int) -> None:
        spf = int(np.clip(spf, self.config.spf_min, self.config.spf_max))
        if spf != self.samples_per_frame:
            self.samples_per_frame = spf
            self.reset_accumulation()  # main.cu:328-332

    def reset_accumulation(self) -> None:
        self.accum = jnp.zeros((self.height, self.width, 3), jnp.float32)
        self.sample_count = 0

    # -- the frame step (main.cu:333-337) --------------------------------
    def step(self, num_samples: Optional[int] = None,
             sync: Optional[bool] = None) -> None:
        """Add ``num_samples`` fresh samples to the accumulation buffer.

        ``sync=True`` blocks until the device finishes (the reference's
        per-frame cudaDeviceSynchronize, main.cu:336, and what makes
        ``frame_ms`` meaningful).  ``sync=False`` lets successive steps
        pipeline on the device — right for batch/throughput use.  Default
        comes from ``config.sync_each_frame``."""
        ns = num_samples or self.samples_per_frame
        if sync is None:
            sync = self.config.sync_each_frame
        t0 = time.perf_counter()
        self.accum = _accumulate_step(
            self.scene, self._cam_data, self.accum,
            jnp.uint32(self.sample_count), self.width, self.height, ns,
            self.config.seed, self.config.max_depth, self.mode,
            self.config.enable_nee, self.config.rr_start_depth)
        if sync:
            self.accum.block_until_ready()
        self.frame_ms = (time.perf_counter() - t0) * 1e3
        self.sample_count += ns

    # -- output ----------------------------------------------------------
    def framebuffer(self) -> np.ndarray:
        """Tonemapped uint8 [H,W,3] (UpdateTexture semantics)."""
        return img_util.tonemap(np.asarray(self.accum), self.sample_count)

    def hdr(self) -> np.ndarray:
        return np.asarray(self.accum) / max(self.sample_count, 1)

    def save_png(self, path: str) -> None:
        img_util.write_png(path, self.framebuffer())

    # -- checkpoint / resume (capability beyond the reference; SURVEY §5) -
    def save_checkpoint(self, path: str) -> None:
        img_util.save_exr_like_npz(
            path, np.asarray(self.accum), self.sample_count,
            camera=np.array(self.camera.lookfrom + self.camera.lookat
                            + self.camera.up + (self.camera.vfov,)))

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        accum = data["accum"]
        if accum.shape != (self.height, self.width, 3):
            raise ValueError("checkpoint resolution mismatch")
        cam = data["camera"]
        self.set_camera(Camera(tuple(cam[0:3]), tuple(cam[3:6]),
                               tuple(cam[6:9]), float(cam[9])))
        self.accum = jnp.asarray(accum)
        self.sample_count = int(data["sample_count"])
