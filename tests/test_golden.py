"""Regression goldens of this renderer.

``tests/goldens/`` holds high-spp renders of corpus scenes, recorded with
this renderer by tools/golden_check.py together with each scene's
seed-to-seed tile noise at 24 spp (``calibration.json``).  These tests
render the same scenes at low spp and assert tile-mean agreement within
that noise: a BRDF, emission, camera or gamma (sqrt tonemap,
opengl_display.cpp:104-111) regression fails, since a gamma drift moves
the mean tile |d| by ~0.15 and an emission scale error by >0.1.
"""

import json
import os

import numpy as np
import pytest

from torrey.render.renderer import ProgressiveRenderer
from torrey.utils.image import read_png

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
with open(os.path.join(GOLDENS, "calibration.json")) as _f:
    CAL = json.load(_f)


def _tiles(img: np.ndarray, grid) -> np.ndarray:
    h, w = img.shape[:2]
    gh, gw = grid
    th, tw = h // gh, w // gw
    return img[:gh * th, :gw * tw].reshape(gh, th, gw, tw, 3).mean(axis=(1, 3))


def _downsample(img: np.ndarray, f: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img.reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def _render(scenes_dir, entry, W, H, spp):
    r = ProgressiveRenderer.from_xml(os.path.join(scenes_dir, entry["xml"]),
                                     width=W, height=H)
    while r.sample_count < spp:
        r.step(min(8, spp - r.sample_count))
    return r.framebuffer().astype(np.float32) / 255.0


# quick cases: half resolution, 24 spp, on a coarse tile grid where the
# recorded 24-spp noise (measured on the finer grid) bounds the error
@pytest.mark.parametrize("name", ["scene1_phong", "cbox"])
def test_golden_image(scenes_dir, name):
    entry = CAL[name]
    ref = read_png(os.path.join(GOLDENS, f"{name}.png")).astype(np.float32)
    ref = _downsample(ref / 255.0, 2)
    ours = _render(scenes_dir, entry, entry["W"] // 2, entry["H"] // 2, 24)
    tr, to = _tiles(ref, (6, 8)), _tiles(ours, (6, 8))
    d = np.abs(tr - to)
    mean_tol = 3.0 * entry["tile_noise_mean_24spp"] + 0.01
    max_tol = 3.0 * entry["tile_noise_max_24spp"] + 0.02
    assert d.mean() < mean_tol, (name, d.mean(), mean_tol)
    assert d.max() < max_tol, (name, d.max(), max_tol)
    # global per-channel brightness (catches emission/gamma scale errors
    # even if they were spatially uniform)
    gd = np.abs(tr.mean(axis=(0, 1)) - to.mean(axis=(0, 1)))
    assert gd.max() < mean_tol, (name, gd)


# full cases: the recorded resolution at 24 spp.  Tolerance = recorded
# noise floor x 3 (different seeds here AND different sample counts) plus
# a small absolute term for tonemap quantization.
@pytest.mark.parametrize("name,entry", sorted(CAL.items()),
                         ids=sorted(CAL))
def test_recorded_golden(scenes_dir, name, entry):
    ref = read_png(os.path.join(GOLDENS, f"{name}.png"))
    ref = ref.astype(np.float32) / 255.0
    ours = _render(scenes_dir, entry, entry["W"], entry["H"], 24)
    tr, to = _tiles(ref, (12, 16)), _tiles(ours, (12, 16))
    d = np.abs(tr - to)
    mean_tol = 3.0 * entry["tile_noise_mean_24spp"] + 0.01
    max_tol = 3.0 * entry["tile_noise_max_24spp"] + 0.02
    assert d.mean() < mean_tol, (name, d.mean(), mean_tol)
    assert d.max() < max_tol, (name, d.max(), max_tol)
