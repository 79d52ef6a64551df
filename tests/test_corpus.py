"""Whole-corpus integration sweep: every scene of the repository's corpus
parses, packs, renders non-trivially and reproduces bit-exactly under a
fixed seed (SURVEY.md §4 b/d)."""

import glob
import os

import numpy as np
import pytest

import jax.numpy as jnp

from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops import integrator
from torrey.ops.camera import Camera, camera_ray_data

ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
SCENES = sorted(glob.glob(os.path.join(ROOT, "*", "*.xml")))
W, H = 64, 48


def test_corpus_is_complete():
    assert len(SCENES) == 14


@pytest.mark.parametrize("xml", SCENES,
                         ids=lambda s: os.path.relpath(s, ROOT))
def test_scene_renders_and_reproduces(xml):
    pack, parsed = load_scene(xml)
    assert pack.num_prims > 0
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    a = np.asarray(integrator.render_samples(ds, cd, W, H, 0, 1, max_depth=4))
    assert np.isfinite(a).all()
    assert a.max() > 0.01, "image is black"
    assert a.std() > 1e-4, "image is constant"
    b = np.asarray(integrator.render_samples(ds, cd, W, H, 0, 1, max_depth=4))
    np.testing.assert_array_equal(a, b)  # deterministic under fixed seed
