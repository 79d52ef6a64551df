"""Record the regression goldens of tests/test_golden.py.

Renders each case at high spp and writes ``tests/goldens/<name>.png``, plus
a seed-to-seed noise floor at the test's 24 spp into
``tests/goldens/calibration.json``.  tests/test_golden.py compares low-spp
renders against these with tolerances tied to that noise floor, so a
BRDF, emission, camera or gamma regression fails.

Run:  python tools/golden_check.py [--record] [--cases cbox,teapot]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from torrey.render.renderer import ProgressiveRenderer  # noqa: E402
from torrey.utils.config import RenderConfig  # noqa: E402
from torrey.utils.image import write_png  # noqa: E402

SCENES = os.path.join(ROOT, "scenes")
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")

# name, scene xml, W, H, spp
CASES = [
    ("cbox", "cbox/cbox.xml", 128, 128, 256),
    ("bunny", "bunny/bunny.xml", 160, 120, 64),
    ("scene1_phong", "spheres/scene1_spherical_light_phong.xml",
     160, 120, 256),
    ("teapot", "teapot/teapot_constant.xml", 128, 96, 256),
    ("scene1_area", "spheres/scene1_spherical_light.xml", 128, 96, 256),
]

GRID = (12, 16)  # tile grid (rows, cols)


def tiles(img, grid=GRID):
    h, w = img.shape[:2]
    gh, gw = grid
    th, tw = h // gh, w // gw
    img = img[:gh * th, :gw * tw].reshape(gh, th, gw, tw, 3)
    return img.mean(axis=(1, 3))


def render(xml, W, H, spp, seed=1984):
    # one 8-spp step size for every call keeps each case at one compile
    assert spp % 8 == 0, spp
    r = ProgressiveRenderer.from_xml(xml, width=W, height=H,
                                     config=RenderConfig(seed=seed))
    t0 = time.time()
    while r.sample_count < spp:
        r.step(8, sync=False)
    img = r.framebuffer().astype(np.float32) / 255.0  # forces the readback
    return img, r.mode, time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true",
                    help="write tests/goldens/*.png + calibration.json")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: all)")
    args = ap.parse_args()
    os.makedirs(GOLDEN_DIR, exist_ok=True)

    only = set(args.cases.split(",")) if args.cases else None
    calib = {}
    cal_path = os.path.join(GOLDEN_DIR, "calibration.json")
    if os.path.exists(cal_path):
        with open(cal_path) as f:
            calib = json.load(f)

    for name, xml, W, H, spp in CASES:
        if only and name not in only:
            continue
        path = os.path.join(SCENES, xml)
        ours, mode, dt = render(path, W, H, spp)
        entry = {"xml": xml, "W": W, "H": H, "spp": spp, "mode": mode,
                 "render_s": round(dt, 1)}

        # seed-to-seed noise floor at the TEST spp (24) — what the test's
        # tolerance must exceed
        a, _, _ = render(path, W, H, 24, seed=1984)
        b, _, _ = render(path, W, H, 24, seed=777)
        entry["tile_noise_mean_24spp"] = round(
            float(np.abs(tiles(a) - tiles(b)).mean()), 5)
        entry["tile_noise_max_24spp"] = round(
            float(np.abs(tiles(a) - tiles(b)).max()), 5)
        print(f"{name}: {json.dumps(entry)}", flush=True)

        if args.record:
            write_png(os.path.join(GOLDEN_DIR, f"{name}.png"),
                      (ours * 255.99).clip(0, 255).astype(np.uint8))
            calib[name] = entry

    if args.record:
        with open(cal_path, "w") as f:
            json.dump(calib, f, indent=1, sort_keys=True)
        print(f"recorded -> {GOLDEN_DIR}")


if __name__ == "__main__":
    main()
