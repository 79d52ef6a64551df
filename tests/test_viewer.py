"""Camera-controller semantics (imgui_manager.cpp parity) + HTTP viewer
smoke test on the CPU platform."""

import json
import math
import urllib.request

import numpy as np
import pytest

from torrey.ops.camera import Camera
from torrey.utils.config import RenderConfig
from torrey.viewer.controls import CameraController


def _cam():
    return Camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 45.0)


def test_fly_forward_moves_along_front():
    c = CameraController(_cam())
    c.fly(forward=1.0)
    # front is -z; speed 0.5 (imgui_manager.cpp:143)
    np.testing.assert_allclose(c.camera.lookfrom, (0, 0, -0.5), atol=1e-6)
    # lookat rides one unit ahead of lookfrom (imgui_manager.cpp:180)
    np.testing.assert_allclose(c.camera.lookat, (0, 0, -1.5), atol=1e-6)


def test_fly_strafe_moves_along_right():
    c = CameraController(_cam())
    c.fly(strafe=1.0)   # right of -z view with +y up is -x... cross(front,up)
    front = (0, 0, -1)
    right = np.cross(front, (0, 1, 0))  # (1,0,0)... check with numpy oracle
    np.testing.assert_allclose(c.camera.lookfrom, tuple(0.5 * right),
                               atol=1e-6)


def test_orbit_preserves_distance_and_lookat():
    cam = Camera((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0)
    c = CameraController(cam)
    c.orbit_begin(100, 100)
    c.orbit_drag(150, 80)
    c.orbit_drag(170, 60)
    got = c.camera
    assert got.lookat == cam.lookat          # orbits around captured lookat
    d = math.dist(got.lookfrom, got.lookat)
    assert abs(d - 3.0) < 1e-6               # fixed orbit radius
    assert not np.allclose(got.lookfrom, cam.lookfrom)


def test_orbit_pitch_clamped_to_89_degrees():
    cam = Camera((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0)
    c = CameraController(cam)
    c.orbit_begin(0, 0)
    # screen y grows downward: dragging far UP (y -> -inf) pitches the view
    # up until the +89 deg clamp; camera ends below the lookat
    c.orbit_drag(0, -100000)
    y = c.camera.lookfrom[1]
    assert y < 0
    assert abs(-y / 3.0 - math.sin(math.radians(89))) < 1e-4


def test_fov_clamp_and_reset():
    c = CameraController(_cam())
    c.set_fov(500)
    assert c.camera.vfov == 120.0   # imgui_manager.cpp:101 slider max
    c.set_fov(1)
    assert c.camera.vfov == 10.0
    c.fly(forward=1.0)
    c.reset()
    assert c.camera == _cam()


def test_no_drag_without_begin():
    c = CameraController(_cam())
    c.orbit_drag(50, 50)
    assert c.camera == _cam()


@pytest.fixture(scope="module")
def viewer(scenes_dir):
    from torrey.render.renderer import (
        ProgressiveRenderer)
    from torrey.viewer.server import Viewer

    r = ProgressiveRenderer.from_xml(
        f"{scenes_dir}/spheres/scene1.xml",
        RenderConfig(max_depth=4), width=64, height=48)
    v = Viewer(r, port=0)  # ephemeral port
    v.start()
    yield v
    v.stop()


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}",
                                timeout=30) as resp:
        return resp.read()


def _post(v, ev):
    req = urllib.request.Request(f"http://127.0.0.1:{v.port}/event",
                                 data=json.dumps(ev).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def test_viewer_serves_page_and_frames(viewer):
    page = _get(viewer, "/")
    assert b"Scene Controls" in page and b"Performance" in page
    frame = _get(viewer, "/frame")
    assert frame[:8] == b"\x89PNG\r\n\x1a\n"
    state = json.loads(_get(viewer, "/state"))
    assert state["size"] == [64, 48]
    assert state["camera"]["vfov"] > 0


def test_viewer_events_drive_camera_and_reset(viewer):
    import time
    state0 = json.loads(_get(viewer, "/state"))
    _post(viewer, {"type": "fly", "forward": 1.0})
    deadline = time.time() + 30
    while time.time() < deadline:
        st = json.loads(_get(viewer, "/state"))
        if not np.allclose(st["camera"]["lookfrom"],
                           state0["camera"]["lookfrom"]):
            break
        time.sleep(0.2)
    else:
        raise AssertionError("camera never moved")
    _post(viewer, {"type": "reset"})
    deadline = time.time() + 30
    while time.time() < deadline:
        st = json.loads(_get(viewer, "/state"))
        if np.allclose(st["camera"]["lookfrom"],
                       state0["camera"]["lookfrom"]):
            break
        time.sleep(0.2)
    else:
        raise AssertionError("reset never applied")
    assert json.loads(_post(viewer, {"type": "spf", "value": 99}) or b"{}") == {}
    st = json.loads(_get(viewer, "/state"))
    assert st["spf"] == 10  # clamped to slider max
