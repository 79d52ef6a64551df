"""Headline benchmark: progressive rendering on one GPU vs the reference.

The primary metric mirrors the reference's headline interactive
configuration (README.md:113 of the reference): cbox at 640x480,
progressive accumulation, 2 samples/pixel/frame, depth 50 with Russian
roulette.  Secondary metrics: the synced frame latency (the reference syncs
every frame, main.cu:336), Mrays/s (Msamples/s x the average path length
counted by integrator.measure_path_stats), and the 144,046-triangle bunny
stand-in through the renderer's BVH path.

Every timing ends with ``block_until_ready``.  The run needs a GPU and
fails without one.  Prints ONE JSON line naming the device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops import integrator
from torrey.ops.camera import Camera, camera_ray_data
from torrey.render.renderer import ProgressiveRenderer

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
CBOX = os.path.join(SCENES, "cbox", "cbox.xml")
BUNNY = os.path.join(SCENES, "bunny", "bunny.xml")
W, H, SPF = 640, 480, 2
# The reference's published frame rates on an RTX 3080 at 640x480, 2 spp
# per frame (its README.md:113-124), as Msamples/s at the quoted midpoints:
# cbox 55-65 FPS, bunny 45-50 FPS.
REF_RTX3080_CBOX = 0.060 * W * H * SPF / 1e3
REF_RTX3080_BUNNY = 0.0475 * W * H * SPF / 1e3


def _synced_frames(r, frames: int) -> list:
    times = []
    for _ in range(frames):
        r.step(SPF, sync=True)
        times.append(r.frame_ms)
    return times


def _pipelined_msamples_s(r, frames: int) -> float:
    """Frames dispatched back to back, one wait at the end."""
    r.accum.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(frames):
        r.step(SPF, sync=False)
    r.accum.block_until_ready()
    return frames * SPF * W * H / (time.perf_counter() - t0) / 1e6


def _avg_path_length(xml: str) -> float:
    """Rays per camera sample, counted by the XLA oracle (a property of
    scene + integrator semantics, radiance.cuh:24-77, not of the path)."""
    pack, parsed = load_scene(xml)
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera),
                                     W, H))
    rays, samples = integrator.measure_path_stats(ds, cd, W, H, 0, SPF)
    return float(rays) / float(samples)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")

    t0 = time.perf_counter()
    r = ProgressiveRenderer.from_xml(CBOX, width=W, height=H)
    r.step(SPF, sync=True)
    first_s = time.perf_counter() - t0
    lat = _synced_frames(r, 30)
    msps = _pipelined_msamples_s(r, 60)
    plc = _avg_path_length(CBOX)
    extra = {
        "cbox_mode": r.mode,
        "cbox_time_to_first_frame_s": first_s,
        "cbox_synced_frame_ms_median": float(np.median(lat)),
        "cbox_synced_frame_ms_p90": float(np.percentile(lat, 90)),
        "cbox_avg_path_len": plc,
        "cbox_mrays_s": msps * plc,
    }

    t0 = time.perf_counter()
    b = ProgressiveRenderer.from_xml(BUNNY, width=W, height=H)
    b.step(SPF, sync=True)
    extra["bunny_mode"] = b.mode
    extra["bunny_time_to_first_frame_s"] = time.perf_counter() - t0
    blat = _synced_frames(b, 2)
    bunny_msps = SPF * W * H / float(np.median(blat)) / 1e3
    extra["bunny_synced_frame_ms_median"] = float(np.median(blat))
    extra["bunny_msamples_s"] = bunny_msps
    extra["bunny_vs_reference_rtx3080"] = bunny_msps / REF_RTX3080_BUNNY

    print(json.dumps({
        "metric": "cbox_progressive_throughput",
        "value": msps,
        "unit": "Msamples/s",
        "vs_reference_rtx3080": msps / REF_RTX3080_CBOX,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
